"""Faults planted under the timed path, to see the output check catch them:
the CPU tests plant them at a tiny width, ``benchmark.control --fault`` on
the card at the cell's own size. The benchmark's own runs never plant one.

- ``frozen_step``: every Euler step returns its latents unchanged; every
  optimizer step leaves the adapters as they were.
- ``half_batch``: the DiT computes the first half of a batch's rows and
  gives the rest their mean.
- ``altered_answer``: the PNG's pixels inverted where the server makes them;
  the gradient scaled by 1.5 where the optimizer takes it.

Every cell runs on one chip, so the fault of an exchange between chips
left out does not apply.
"""

import torch

def plant(fault: str) -> None:
    from flux2_tpu_torch.training import trainer

    if fault == "frozen_step":
        from flux2_tpu_torch.ops import scheduler

        scheduler.euler_step = lambda sample, velocity, sigma, sigma_next: sample
        trainer.Optimizer.step = lambda self, grads: None
    elif fault == "half_batch":
        from flux2_tpu_torch.models.flux2.transformer import Flux2Transformer

        forward = Flux2Transformer.forward

        def half(self, *args, **kwargs):
            out = forward(self, *args, **kwargs)
            if out.shape[0] < 2:
                return out
            h = out.shape[0] // 2
            return torch.cat([out[:h], out[:h].mean(0, keepdim=True).expand(out.shape[0] - h, -1, -1)])

        Flux2Transformer.forward = half
    elif fault == "altered_answer":
        from flux2_tpu_torch import serve

        to_u8 = serve.to_u8
        serve.to_u8 = lambda image: 255 - to_u8(image)
        step = trainer.Optimizer.step
        trainer.Optimizer.step = lambda self, grads: step(self, [g * 1.5 for g in grads])
    elif fault != "none":
        raise ValueError(fault)
