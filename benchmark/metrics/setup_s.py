"""setup_s: seconds from the process's start to the window's start (capture
synthesis, pipeline build, kernel loading or building, the warm pass, and
in a live cell the feed's lead)."""


def read(rec):
    return rec.setup_s
