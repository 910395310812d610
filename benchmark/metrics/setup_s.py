"""Seconds from the process's start to the window: imports, CUDA start, kernel loads,
inputs made on the card, and the warm-up of the cell's own shapes."""


def read(record):
    return record.setup_s
