"""The device's idle share of the traced window: one minus the union of its operations'
intervals over the window's length."""


def read(record):
    trace = record.trace
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
