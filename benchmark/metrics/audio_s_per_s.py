"""Seconds of audio transcribed in completed calls over the window's wall time."""


def read(record):
    return record.work["audio_s"] / record.window_s
