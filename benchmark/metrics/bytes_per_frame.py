"""Payload bytes of the window's frames over their count."""


def read(run):
    return run.window.payload_bytes / run.window.frames
