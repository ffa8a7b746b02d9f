"""Training: schedules, optimizer, train state, weight transplants, the
flow-supervisor (semi) train step and the loop around it."""
