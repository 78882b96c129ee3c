"""The plain reference against the program at a tiny width on the CPU, both
in float32 on the same seeded checkpoint: the conditioning, the final
latents and the image agree to rounding, stage by stage; the fp8 control
of the denoising and decode stages does not."""

import numpy as np
import torch

from benchmark.models import flux2_klein
from benchmark.reference import text
from benchmark.tests import tiny

PROMPT = "a lighthouse on a cliff at dusk, watercolor"


def test_reference_matches_the_program_at_tiny_width():
    torch.set_num_threads(2)
    pipe = flux2_klein.build_pipeline(tiny.TINY, 2**31 + 7, "cpu")
    pipe.vae_compute_dtype = torch.float32
    res = pipe.generate(prompt=PROMPT, height=64, width=48, num_steps=2, seed=123)
    cond = pipe.encode_prompt(PROMPT)
    request = {"prompt": PROMPT, "seed": 123, "height": 64, "width": 48, "steps": 2}
    ref = flux2_klein.reference_requests(tiny.TINY, 2**31 + 7, "cpu", [
        {"request": request, "cond": cond.float(), "latents": res.latents_device.float()}])[0]
    assert cond.shape == ref["cond"].shape == (1, 512, 192)
    assert float((cond - ref["cond"]).norm() / ref["cond"].norm()) < 1e-5
    assert float((res.latents_device - ref["latents"]).norm() / ref["latents"].norm()) < 1e-5
    img = torch.from_numpy(np.rint(res.image * 255.0).astype(np.uint8))
    assert img.shape == ref["image"].shape == (64, 48, 3)
    assert int((img.int() - ref["image"].int()).abs().max()) <= 1
    ctl = flux2_klein.reference_requests(tiny.TINY, 2**31 + 7, "cpu", [
        {"request": request, "cond": cond.float(), "latents": res.latents_device.float()}], fp8_control=True)[0]
    assert float((ctl["image_fp8"].double() - ref["image"].double()).abs().mean()) > 1.0
    assert float((ctl["latents_fp8"] - ref["latents"]).norm() / ref["latents"].norm()) > 1e-3


def test_klein_ids_follow_the_recipe():
    tok = text.WordTokenizer()
    ids, mask = text.klein_ids(tok, "a red fox")
    assert ids.shape == mask.shape == (1, 512)
    n = int(mask.sum())
    assert ids[0, 0] == text.SPECIAL_IDS["<|im_start|>"]
    assert (ids[0, n:] == text.PAD_ID).all() and (mask[0, :n] == 1).all()
    assert text.SPECIAL_IDS["</think>"] in ids[0, :n].tolist()
    long_ids, long_mask = text.klein_ids(tok, " ".join(["word"] * 900))
    assert int(long_mask.sum()) == 512


def test_seeded_checkpoint_redraws_the_same_bits():
    from benchmark import weights

    a = weights.checkpoints(tiny.TINY, 5, "cpu")["transformer"]
    b = weights.checkpoints(tiny.TINY, 5, "cpu")["transformer"]
    keys = list(a)
    assert torch.equal(a[keys[-1]], b[keys[-1]]) and torch.equal(a[keys[0]], b[keys[0]])
    c = weights.checkpoints(tiny.TINY, 6, "cpu")["transformer"]
    assert not torch.equal(a[keys[0]], c[keys[0]])
