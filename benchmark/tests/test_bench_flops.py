"""The yardstick's counts against hand counts at the Klein widths."""

import pytest

from benchmark import flops, spec

K4B = spec.load_json(spec.BENCH_DIR / "configs" / "klein-4b.json")
K9B = spec.load_json(spec.BENCH_DIR / "configs" / "klein-9b.json")


def test_flash_forward_klein4b_1024():
    ops, nbytes = flops.attention_fwd(1, 24, 4608, 4608, 128)
    assert ops == 4 * 24 * 4608 * 4608 * 128 == 260_919_263_232
    assert nbytes == 2 * 24 * 128 * 4 * 4608 == 113_246_208
    # the forward is bound by its operations: 0.2638 ms at 989 TFLOP/s (PERF.md's K1 row)
    assert flops.roofline_s(ops, nbytes, flops.H100_SXM) == pytest.approx(2.638e-4, rel=1e-3)


def test_flash_backward_klein4b_1024():
    ops3, bytes3 = flops.attention_bwd_dq(1, 24, 4608, 4608, 128)
    ops4, bytes4 = flops.attention_bwd_dkv(1, 24, 4608, 4608, 128)
    assert ops3 == 391_378_894_848 and ops4 == 521_838_526_464
    assert bytes3 == 2 * 24 * 128 * 5 * 4608 + 8 * 24 * 4608 == 142_442_496
    assert bytes4 == 2 * 24 * 128 * 6 * 4608 + 8 * 24 * 4608 == 170_754_048
    assert flops.roofline_s(ops3, bytes3, flops.H100_SXM) == pytest.approx(3.957e-4, rel=1e-3)
    assert flops.roofline_s(ops4, bytes4, flops.H100_SXM) == pytest.approx(5.276e-4, rel=1e-3)


def test_dit_step_klein4b_and_9b_1024():
    s = 4608
    block4 = 2 * s * (4 * 3072 ** 2 + 3 * 3072 * 9216) + 4 * s * s * 3072
    emb4 = 2 * 4096 * 128 * 3072 + 2 * 512 * 7680 * 3072 + 2 * 4096 * 3072 * 128
    assert flops.dit_step(K4B["transformer"], 4096) == 25 * block4 + emb4 == pytest.approx(34.80e12, rel=1e-3)
    block9 = 2 * s * (4 * 4096 ** 2 + 3 * 4096 * 12288) + 4 * s * s * 4096
    emb9 = 2 * 4096 * 128 * 4096 + 2 * 512 * 12288 * 4096 + 2 * 4096 * 4096 * 128
    assert flops.dit_step(K9B["transformer"], 4096) == 32 * block9 + emb9 == pytest.approx(75.51e12, rel=1e-3)


def test_encoder_qwen3_4b_through_layer_27():
    per_layer = 2 * 512 * (2 * 2560 * 4096 + 2 * 2560 * 1024 + 3 * 2560 * 9728) + 2 * 512 * 512 * 4096
    assert flops.encoder(K4B["text_encoder"]) == 27 * per_layer == pytest.approx(2.848e12, rel=1e-3)


def test_vae_decode_1024():
    def conv(cin, cout, k, px):
        return 2 * cin * cout * k * k * px

    a, b, c, d = 128 * 128, 256 * 256, 512 * 512, 1024 * 1024  # pixels at each level
    total = conv(32, 32, 1, a) + conv(32, 512, 3, a)
    total += 4 * conv(512, 512, 3, a)  # the mid block's two resnets
    total += 4 * 2 * a * 512 * 512 + 4 * a * a * 512  # its attention
    total += 6 * conv(512, 512, 3, a) + conv(512, 512, 3, b)  # up block 0, upsample to 256
    total += 6 * conv(512, 512, 3, b) + conv(512, 512, 3, c)  # up block 1
    total += conv(512, 256, 3, c) + 5 * conv(256, 256, 3, c) + conv(512, 256, 1, c) + conv(256, 256, 3, d)
    total += conv(256, 128, 3, d) + 5 * conv(128, 128, 3, d) + conv(256, 128, 1, d)  # up block 3
    total += conv(128, 3, 3, d)
    assert flops.vae_decode(K4B["vae"], 1024, 1024) == total


def test_t2i_image_sums_its_parts():
    img = flops.t2i_image(K4B, 1024, 1024, 4)
    assert img == (flops.encoder(K4B["text_encoder"]) + 4 * flops.dit_step(K4B["transformer"], 4096)
                   + flops.vae_decode(K4B["vae"], 1024, 1024))
    assert 150e12 < img < 160e12


def test_peaks_only_for_the_h100():
    assert flops.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    with pytest.raises(ValueError):
        flops.peaks("cpu")
