"""The port's segmenter initialisation and trainer against the JAX package's, on the CPU.

``flux2_tpu_torch/tools/train_segmenter.py`` against JAX's functions,
imported from ``tools/train_segmenter.py``: on JAX's own ``init_params``
weights and a batch of two 64x64 composites the loss is within 1e-5 relative
and every gradient leaf within 1e-4 relative L2; the schedule equals optax's
``cosine_decay_schedule(lr, n, 0.05)`` within 1e-7 at steps 0, 1, n/2 and
n-1; three Adam steps from the same gradients stay within 1e-5 relative L2 of
optax's ``adam``. ``make_batch`` draws JAX's composites from the same
``RandomState``; ``segmenter.init_params`` gives JAX's shapes, He-normal
kernels and zero biases (from a ``torch.Generator``, so other values); the
CLI at ``--steps 3 --batch 2`` prints JAX's four kinds of line and writes a
file that ``load_params`` reads back to the bit.
"""

import contextlib
import importlib.util
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flux2_tpu.chains import segmenter as jseg
from flux2_tpu.chains.subject_mask import saliency_foreground
from flux2_tpu_torch.chains import segmenter as tseg
from flux2_tpu_torch.io import safetensors_io
from flux2_tpu_torch.tools import train_segmenter as ttrain

from tests.test_torch_lora_loader import one_torch_thread  # noqa: F401  (module fixture)

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "train_segmenter.py")


@pytest.fixture(scope="module")
def jtrain():
    spec = importlib.util.spec_from_file_location("jax_train_segmenter", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(params, prefix=""):
    out = {}
    for k, v in params.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v, np.float32)})
    return out


def _jax_shapes() -> dict:
    """{JAX name: shape} of JAX's ``init_params`` tree, from ``eval_shape``."""
    tree = jax.eval_shape(jseg.init_params, jax.random.PRNGKey(0))
    return {jax.tree_util.keystr(path, simple=True, separator="."): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _batch(size=64, n=2, seed=3):
    rng = np.random.RandomState(seed)
    imgs, masks = zip(*(jseg.synth_composite(rng, size) for _ in range(n)))
    return np.stack(imgs), np.stack(masks)


def test_make_batch_draws_jax_composites(jtrain):
    ji, jm = jtrain.make_batch(np.random.RandomState(5), 2)
    ti, tm = ttrain.make_batch(np.random.RandomState(5), 2)
    assert ti.shape == (2, 3, 256, 256) and tm.shape == (2, 256, 256)
    np.testing.assert_array_equal(ti.permute(0, 2, 3, 1).numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _nested(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return out


def test_loss_and_gradients_equal_jax(jtrain):
    """JAX's ``loss_fn`` and ``jax.grad`` against the port's on the same weights (the port's
    ``init_params`` in JAX's layout)."""
    model = tseg.init_params(torch.Generator().manual_seed(0))
    jparams = _nested({k: (v.permute(2, 3, 1, 0) if k.endswith(".kernel") else v).numpy()
                       for k, v in model.state_dict().items()})
    imgs, masks = _batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(jtrain.loss_fn))(jparams, jnp.asarray(imgs), jnp.asarray(masks))
    names, params = zip(*model.named_parameters())
    loss = ttrain.loss_fn(model, torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(masks))
    grads = torch.autograd.grad(loss, params)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jflat = _flat(jgrads)
    assert set(names) == set(jflat)
    for name, g in zip(names, grads):
        g = g.permute(2, 3, 1, 0) if name.endswith(".kernel") else g  # OIHW -> JAX's HWIO
        assert _rel(g.numpy(), jflat[name]) <= 1e-4, name


@pytest.mark.parametrize("n", [10, 1500])
def test_schedule_equals_optax(n):
    ours, want = ttrain.cosine_decay_schedule(2e-3, n, 0.05), optax.cosine_decay_schedule(2e-3, n, 0.05)
    for count in (0, 1, n // 2, n - 1):
        assert abs(ours(count) - float(want(count))) <= 1e-7, count


def test_three_adam_steps_equal_optax():
    rng = np.random.RandomState(0)
    shapes = {"k": (3, 3, 4, 8), "b": (8,)}
    start = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    opt = optax.adam(optax.cosine_decay_schedule(2e-3, 5, 0.05))
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    state = opt.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(start[k].copy())) for k in shapes]
    ours = ttrain.Adam(params, ttrain.cosine_decay_schedule(2e-3, 5, 0.05))
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state)
        jp = optax.apply_updates(jp, updates)
        ours.step([torch.from_numpy(g[k]) for k in shapes])
        for i, (p, k) in enumerate(zip(params, shapes)):
            assert _rel(p.detach().numpy(), np.asarray(jp[k])) <= 1e-5, k
            assert _rel(ours.mu[i].numpy(), np.asarray(state[0].mu[k])) <= 1e-6, k
            assert _rel(ours.nu[i].numpy(), np.asarray(state[0].nu[k])) <= 1e-6, k
    assert ours.count == 3 == int(state[0].count)


def test_init_params_has_jax_shapes_and_he_normal_kernels():
    model = tseg.init_params(torch.Generator().manual_seed(0))
    state = {k: v.permute(2, 3, 1, 0) if k.endswith(".kernel") else v for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == _jax_shapes()
    for k, v in state.items():
        if k.endswith(".kernel"):
            kh, kw, cin, _ = v.shape
            std = (2.0 / (kh * kw * cin)) ** 0.5
            assert abs(float(v.std()) / std - 1) < (0.1 if v.numel() > 1000 else 0.5), k
        elif k.endswith("scale"):
            assert torch.all(v == 1), k
        else:
            assert torch.all(v == 0), k
    again = tseg.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))


def test_cli_prints_jax_lines_and_writes_a_file_load_params_reads_to_the_bit(tmp_path):
    """``--steps 3 --batch 2``: JAX's four kinds of line (the parameter count and the heuristic's IoU equal
    to JAX's), and the file holds the trained network to the bit, in JAX's names and shapes."""
    out = str(tmp_path / "seg.safetensors")
    buf, saved = io.StringIO(), {}
    real = tseg.save_weights

    def keep(model, path):
        saved.update({k: v.clone() for k, v in model.state_dict().items()})
        real(model, path)
    tseg.save_weights = keep
    try:
        with contextlib.redirect_stdout(buf):
            assert ttrain.main(["--steps", "3", "--batch", "2", "--device", "cpu", "--out", out]) == 0
    finally:
        tseg.save_weights = real
    lines = buf.getvalue().splitlines()
    assert lines[0] == f"segmenter params: {sum(int(np.prod(s)) for s in _jax_shapes().values()) / 1e6:.2f}M"
    assert re.fullmatch(r"step 1/3 loss \d+\.\d{4} \(\d+s\)", lines[1]), lines[1]
    rng = np.random.RandomState(10_000)
    heuristic = np.mean([jseg.iou(saliency_foreground(img), mask) for img, mask in
                         (jseg.synth_composite(rng) for _ in range(16))])
    m = re.fullmatch(r"held-out IoU: model (\d\.\d{3}) vs heuristic (\d\.\d{3})", lines[2])
    assert m and m.group(2) == f"{heuristic:.3f}", lines[2]
    assert lines[3] == f"weights -> {out}" and len(lines) == 4
    flat = safetensors_io.load_file(out)
    assert {k: tuple(v.shape) for k, v in flat.items()} == _jax_shapes()
    back = tseg.load_params(tseg.SegmenterUNet(), flat).state_dict()
    assert set(back) == set(saved)
    for k, v in saved.items():
        assert torch.equal(back[k], v), k
