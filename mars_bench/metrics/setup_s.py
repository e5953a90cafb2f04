"""Seconds from the process's start to the first arrival of the lead-in:
imports, kernel libraries (built on a checkout's first run, found
after), weights made on the card, engine and backend, the warm-up."""


def read(run):
    return (run.setup_s, 1)
