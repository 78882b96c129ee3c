"""queue_wait_ms.serve (ms; layer: server micro-batcher; moves
images_per_s): the mean of the program's ``serve.queue`` spans that ended
in the traced window: a request's wait in ``Flux2Server``'s queue, from its
enqueue (after its prompt's encode) to the pick of its batch."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.program_spans(run, "serve.queue"))
