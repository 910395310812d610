"""Utterances trained in the window over the window's wall time; a call counts when its
loss has been read back."""


def read(record):
    return record.work["utterances"] / record.window_s
