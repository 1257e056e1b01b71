"""Mean host ms of Session.render() to a synchronise, over the traced window."""
from portbench import readers


def read(run):
    return readers.span_ms(run, "render")
