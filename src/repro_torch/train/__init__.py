"""Training: the train step and the fault-tolerant trainer."""
