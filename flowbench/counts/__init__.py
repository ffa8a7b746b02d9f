"""The benchmark's arithmetic: the card's published peaks (``peaks.json``),
the model FLOPs that ``mfu.*`` counts (``flops``) and the least work of a
correlation lookup and its backward (``lookup``)."""
