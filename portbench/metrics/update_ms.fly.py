"""Mean host ms of Session.update() over the traced window."""
from portbench import readers


def read(run):
    return readers.span_ms(run, "update")
