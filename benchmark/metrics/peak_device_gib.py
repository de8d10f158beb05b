"""The card's peak allocated memory over the window's jobs, in GiB."""


def read(rec):
    return rec["peak_window_bytes"] / (1 << 30)
