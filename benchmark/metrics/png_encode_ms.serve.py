"""png_encode_ms.serve (ms; layer: PNG encode; moves images_per_s): the
mean of the program's ``serve.png`` spans that ended in the traced window:
``encode_png(to_u8(image))`` on the request's thread, in
``Flux2Server.generate_png``."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.program_spans(run, "serve.png"))
