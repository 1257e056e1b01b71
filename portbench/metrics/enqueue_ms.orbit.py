"""Host ms a frame in ray generation and ``render_frame`` (``render.raygen``,
``render.frame``): the frame's enqueue, from the program's spans."""
from portbench import spans


def read(run):
    return spans.span_ms(run, "orbit", "render.raygen", "render.frame")
