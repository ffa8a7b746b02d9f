"""The benchmark's plain reference: plain PyTorch and numpy that import
nothing of the program under test (``raft``: RAFT and GMA inference and
the evaluation's teacher split; ``semi``: the flow supervisor's train step;
``warm_start``: the evaluation's warm start; ``precision``: the controls'
lower precisions)."""
