"""The FLUX.2-dev cell's program path against its plain reference, at a tiny
width on the CPU, on one torch thread: ``benchmark/models/flux2_dev.py``'s
``build_pipeline`` (the port's loaders, the Mistral extractor,
``Flux2Pipeline(model=DEV)``) against ``benchmark/reference/mistral.py`` and
``reference/dev.py``, stage by stage, both in float32 on the same seeded
checkpoint; a guidance term dropped from the reference shows; the int8
yardstick (``benchmark/flops_int8.py``) against hand-counted shapes and
against the K5 products a tiny w8a8 step makes; the system prompt's copy
against the program's."""

from __future__ import annotations

import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import flops, flops_int8
from benchmark.models import flux2_dev
from benchmark.reference import dev, mistral

SEED = 2**31 + 11
PROMPT = "a lighthouse on a cliff at dusk, watercolor [IMG]"

TINY_DEV = {
    "name": "tiny-dev", "architecture": "flux2_dev", "model": "dev", "dtype": "float32", "quantization": "bf16",
    "guidance": 4.0,
    "transformer": {"patch_size": 1, "in_channels": 128, "out_channels": 128, "num_layers": 1, "num_single_layers": 2,
                    "attention_head_dim": 128, "num_attention_heads": 2, "joint_attention_dim": 192,
                    "pooled_projection_dim": 768, "guidance_embeds": True, "axes_dims_rope": [32, 32, 32, 32],
                    "rope_theta": 2000.0, "mlp_ratio": 3.0, "time_embed_channels": 256},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 32, "block_out_channels": [8, 8, 16, 16],
            "layers_per_block": 1, "norm_num_groups": 4, "norm_eps": 1e-6},
    # Mistral-shaped: no q/k norm, llama4 scaling, untied head; 31 layers, so that hidden state 30 exists
    "text_encoder": {"vocab_size": 2000, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 31,
                     "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16, "rms_norm_eps": 1e-5,
                     "rope_theta": 1000000.0, "llama4_scaling_beta": 0.1, "original_max_position_embeddings": 16384,
                     "tie_word_embeddings": False, "hidden_layers": [10, 20, 30], "max_length": 512},
}
REQUEST = {"prompt": PROMPT, "seed": 123, "height": 64, "width": 48, "steps": 2}

# Tolerances, float32 program against float32 reference on the same weights:
# the two differ only in the order of their sums, ~1e-7 an operation,
# grown through 31 encoder layers (cond) and two DiT steps (latents).
COND_TOL = 1e-5
LATENTS_TOL = 1e-5
# image: uint8 levels of decodes of the same latents; the program rounds its
# float32 decode to levels itself (``io.png.to_u8``), the reference with
# round(), so a level may differ by one
IMAGE_MAX_LEVELS = 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def served():
    pipe = flux2_dev.build_pipeline(TINY_DEV, SEED, "cpu")
    pipe.vae_compute_dtype = torch.float32
    res = pipe.generate(prompt=PROMPT, height=REQUEST["height"], width=REQUEST["width"], num_steps=2,
                        seed=REQUEST["seed"])
    cond = pipe.encode_prompt(PROMPT)
    image = torch.from_numpy(np.rint(res.image * 255.0).astype(np.uint8))
    return {"request": REQUEST, "cond": cond.float(), "latents": res.latents_device.float(), "image": image}


@pytest.fixture(scope="module")
def reference(served):
    return dev.reference_requests(TINY_DEV, SEED, "cpu", [served])[0]


def test_program_matches_the_reference_stage_by_stage(served, reference):
    assert served["cond"].shape == reference["cond"].shape == (1, 512, 192)
    assert rel(served["cond"], reference["cond"]) < COND_TOL
    assert rel(served["latents"], reference["latents"]) < LATENTS_TOL
    assert served["image"].shape == reference["image"].shape == (64, 48, 3)
    assert int((served["image"].int() - reference["image"].int()).abs().max()) <= IMAGE_MAX_LEVELS


def test_a_guidance_term_dropped_from_the_reference_fails_the_comparison(served, monkeypatch):
    embed = dev._embed
    monkeypatch.setattr(dev, "_embed", lambda ckpt, key, v: embed(ckpt, key, v) * ("guidance" not in key))
    dropped = dev.reference_requests(TINY_DEV, SEED, "cpu", [served])[0]
    assert rel(served["latents"], dropped["latents"]) > 100 * LATENTS_TOL
    assert rel(served["cond"], dropped["cond"]) < COND_TOL  # the encoder has no guidance


def test_the_control_rounds_as_w4a8(served, reference):
    # 4 heads: a 512-wide stream, so the blocks' products tile by W4A8's 512 (2 of them do at 256)
    cfg = copy.deepcopy(TINY_DEV)
    cfg["transformer"].update(num_attention_heads=4, joint_attention_dim=192)
    want = dev.reference_requests(cfg, SEED, "cpu", [served])[0]
    ctl = dev.reference_requests(cfg, SEED, "cpu", [served], control=True)[0]
    assert rel(ctl["latents_fp8"], want["latents"]) > 1e-3
    assert rel(want["latents"], reference["latents"]) > 0  # another width: another model
    assert float((ctl["image_fp8"].double() - reference["image"].double()).abs().mean()) > 1.0
    w = torch.randn(3, 1024)
    r = dev._round_blocks(w, 7)
    for blk in r.view(3, 2, 512):  # at most 15 levels a block, the largest kept
        assert all(len(torch.unique(row)) <= 15 for row in blk)
    assert torch.allclose(r.abs().view(3, 2, 512).amax(-1), w.abs().view(3, 2, 512).amax(-1))


def test_the_fp8_part_controls_each_move_the_latents():
    got = dev.fp8_part_controls(TINY_DEV, SEED, "cpu", REQUEST)
    assert set(got) == {"attention", "stream", "attention+stream"}
    assert all(1e-3 < v < 1 for v in got.values()), got
    assert len(set(got.values())) == 3  # each part rounds its own tensors
    assert dev.fp8_part_controls(TINY_DEV, SEED, "cpu", REQUEST, parts=((),)) == {"": 0.0}


def test_mistral_ids_follow_the_recipe():
    tok = mistral.TekkenWordTokenizer(2000)
    ids, mask = mistral.mistral_ids(tok, "a red fox [IMG]")
    n = int(mask.sum())
    assert ids.shape == mask.shape == (1, 512) and (mask[0, 512 - n:] == 1).all()
    assert (ids[0, :512 - n] == mistral.PAD).all()  # LEFT padded
    body = ids[0, 512 - n:].tolist()
    assert body[:2] == [mistral.BOS, mistral.SYSTEM] and body[-1] == mistral.END_INST
    assert mistral.END_SYSTEM in body and mistral.INST in body
    assert all(i >= mistral.SPECIAL_IDS for i in tok.encode("a red fox"))
    assert int(mistral.mistral_ids(tok, " ".join(["word"] * 900))[1].sum()) == 512


def test_system_prompt_copy_is_the_programs():
    from flux2_tpu_torch.models.text_encoders import extractor, tekken

    assert mistral.SYSTEM_MESSAGE == extractor.SYSTEM_MESSAGE_EMBEDDINGS
    assert (mistral.BOS, mistral.INST, mistral.END_INST, mistral.PAD, mistral.SYSTEM, mistral.END_SYSTEM) == (
        tekken.DEFAULT_BOS_ID, tekken.DEFAULT_INST_ID, tekken.DEFAULT_END_INST_ID, tekken.DEFAULT_PAD_ID,
        tekken.DEFAULT_SYSTEM_ID, tekken.DEFAULT_END_SYSTEM_ID)
    ids, _ = extractor.prepare_input_ids(mistral.TekkenWordTokenizer(2000), PROMPT)
    assert ids.tolist() == mistral.mistral_ids(mistral.TekkenWordTokenizer(2000), PROMPT)[0].tolist()


def test_int8_counts_against_hand_computed_shapes():
    assert flops_int8.w8a8_matmul(4096, 6144, 18432) == (2.0 * 4096 * 6144 * 18432,
                                                         4096 * 6144 + 6144 * 18432 + 4 * 4096 + 4 * 18432
                                                         + 2 * 4096 * 18432)
    assert flops_int8.quantize_rows(512, 5120) == (0.0, 512 * 5120 * 3 + 4 * 512)
    peak = flops.H100_SXM
    assert flops_int8.roofline_s(1979e12, 0.0, peak) == pytest.approx(1.0)
    assert flops_int8.roofline_s(0.0, 3.35e12, peak) == pytest.approx(1.0)
    dev_t = {**TINY_DEV["transformer"], "num_layers": 8, "num_single_layers": 48, "num_attention_heads": 48,
             "joint_attention_dim": 15360}
    k5, rest = flops_int8.dit_products(dev_t, 4096)
    # 8 prelude products, 12 a double block, 7 a single block: 440; x_embedder (K 128) and proj_out
    # (N 128) fail the gate, norm_out is never quantized
    assert len(k5) == 8 + 8 * 12 + 48 * 7 == 440
    assert rest == [(4096, 128, 6144), (4096, 6144, 128), (1, 6144, 12288)]
    assert k5.count((4608, 6144, 18432)) == 2 * 48 and k5.count((512, 18432, 6144)) == 8
    enc = {"max_length": 512, "hidden_size": 5120, "head_dim": 128, "intermediate_size": 32768,
           "num_attention_heads": 32, "num_key_value_heads": 8, "num_hidden_layers": 40, "hidden_layers": [10, 20, 30]}
    k5e, reste = flops_int8.encoder_products(enc)
    assert len(k5e) == 280 and not reste and k5e[:7] == [
        (512, 5120, 4096), (512, 5120, 1024), (512, 5120, 1024), (512, 4096, 5120), (512, 5120, 32768),
        (512, 5120, 32768), (512, 32768, 5120)]


def test_launch_mix_reads_the_spans():
    cfg, traffic = TINY_DEV, {"sizes": [{"px": 64, "share": 1.0}]}
    shapes = flops_int8.dit_products(cfg["transformer"], 16)[0]
    peak = flops.H100_SXM
    got = flops_int8.launch_mix(cfg, traffic, [{"step": 0, "batch": 1, "w8a8": len(shapes)}], [], peak)
    assert got == (*flops_int8.launches_bound_s(shapes, peak), len(shapes))
    assert flops_int8.launch_mix(cfg, traffic, [{"step": 0, "batch": 1, "w8a8": len(shapes) + 1}], [], peak) is None
    assert flops_int8.launch_mix(cfg, traffic, [{"step": 0, "batch": 1, "glue": 3}], [], peak) is None


def test_mfu_bound_against_a_tiny_w8a8_steps_products(monkeypatch):
    """Every product a tiny w8a8 DiT step and encode make, each routed as the
    card would route it (``quant.kernel_route``), summed: the K5 ones equal
    ``flops_int8``'s K5 list, the rest its bf16 list."""
    from flux2_tpu_torch.models.flux2 import transformer
    from flux2_tpu_torch.models.text_encoders import decoder
    from flux2_tpu_torch.ops import quant

    cfg = copy.deepcopy(TINY_DEV)
    cfg["transformer"]["joint_attention_dim"] = 256 * 3
    cfg["text_encoder"].update(hidden_size=256, intermediate_size=512, head_dim=64)
    pipe = flux2_dev.build_pipeline(cfg, SEED, "cpu", "w8a8")
    seen = {"k5": [], "rest": []}

    def recording(x, w):
        m, k = x.reshape(-1, x.shape[-1]).shape
        n = w.shape[0] if isinstance(w, torch.Tensor) else w.q.shape[0]
        routed = not isinstance(w, torch.Tensor) and quant.kernel_route(x, w) == "w8a8"
        seen["k5" if routed else "rest"].append((m, k, n))
        return q_linear(x, w)

    q_linear = quant.q_linear
    monkeypatch.setattr(transformer, "q_linear", recording)
    monkeypatch.setattr(decoder, "q_linear", recording)
    emb = pipe.encode_prompt(PROMPT)
    enc_k5 = seen["k5"][:]
    k5e, reste = flops_int8.encoder_products(cfg["text_encoder"])
    assert sorted(enc_k5) == sorted(k5e) and sorted(seen["rest"]) == sorted(reste)
    seen["k5"].clear(), seen["rest"].clear()
    pipe.generate(embeddings=emb, height=64, width=64, num_steps=1, seed=0)
    k5, rest = flops_int8.dit_products(cfg["transformer"], 16)
    assert sorted(seen["k5"]) == sorted(k5) and sorted(seen["rest"]) == sorted(rest)
    ops = sum(2.0 * m * k * n for m, k, n in seen["k5"])
    peak = flops.H100_SXM
    attn = flops.dit_attention(cfg["transformer"], 16) / peak["bf16_flops"]
    rest_s = sum(2.0 * m * k * n for m, k, n in seen["rest"]) / peak["bf16_flops"]
    assert flops_int8.dit_step_s(cfg["transformer"], 16, peak) == pytest.approx(
        ops / peak["int8_ops"] + rest_s + attn, rel=1e-12)


def test_the_dev_reference_and_yardstick_load_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.dev, benchmark.reference.mistral, benchmark.weights_dev, "
            "benchmark.flops_int8, benchmark.models.flux2_dev; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'flux2_tpu_torch', 'flux2_tpu', 'jax', 'jaxlib', "
            "'flax'}); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
