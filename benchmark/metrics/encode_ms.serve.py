"""encode_ms.serve (ms; layer: text encoder and its stream wait; moves
images_per_s): the mean of the program's ``pipeline.encode`` spans that
ended in the traced window: a prompt's encode on a cache miss
(``Flux2Pipeline.encode_prompt``), from the prompt lock's acquisition to the
synchronise after the encoder, so without the wait for the lock (the span's
``lock_wait_s``) but with the wait for the batch in flight on the card's one
stream: the encoder shares that stream with the DiT, so a faster DiT
shortens it too."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.program_spans(run, "pipeline.encode"))
