"""A tiny FLUX.2 Klein configuration and a benchmark root around it, for
CPU tests: the whole harness runs on it in seconds."""

import json
import shutil
from pathlib import Path

from benchmark import spec

TINY = {
    "name": "tiny", "architecture": "flux2_klein", "model": "klein-4b", "dtype": "float32",
    "transformer": {"patch_size": 1, "in_channels": 128, "out_channels": 128, "num_layers": 1, "num_single_layers": 2,
                    "attention_head_dim": 128, "num_attention_heads": 2, "joint_attention_dim": 192,
                    "pooled_projection_dim": 768, "guidance_embeds": False, "axes_dims_rope": [32, 32, 32, 32],
                    "rope_theta": 2000.0, "mlp_ratio": 3.0, "time_embed_channels": 256},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 32, "block_out_channels": [8, 8, 16, 16],
            "layers_per_block": 1, "norm_num_groups": 4, "norm_eps": 1e-6},
    # 28 layers: the Klein recipe reads hidden states 9, 18 and 27
    "text_encoder": {"vocab_size": 151936, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 28,
                     "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16, "rms_norm_eps": 1e-6,
                     "rope_theta": 1000000, "tie_word_embeddings": True, "hidden_layers": [9, 18, 27],
                     "max_length": 512},
}

TRAFFIC = {
    "closed": {"kind": "closed", "clients": 2, "sizes": [{"px": 64, "share": 1.0}], "steps": 2,
               "prompt_words": {"median": 10, "sigma": 0.5, "min": 3, "max": 20},
               "check": {"requests": 2, "among": 3}},
}

TRAFFIC["train"] = {"kind": "train", "model": "klein-4b-base", "px": 64, "batch": 2, "pool": 3,
                    "train": {"rank": 4, "alpha": 4.0, "learning_rate": 1e-3, "weight_decay": 0.01,
                              "optimizer": "adamw", "timestep_sampling": "balanced", "max_grad_norm": 1.0,
                              "remat": True, "target_layers": "attention_ffn"},
                    "adapter_b_scale": 0.01, "check": {"steps": 2}}

# float32 program against the float32 reference: rounding only
LIMITS = {"cond_rel_l2": 1e-4, "latents_rel_l2": 1e-4, "image_rel_l2": 0.05,
          "loss_rel_gap": 1e-4, "grad_leaf_gap": 1e-3, "change_leaf_gap": 1e-3}


def make_root(tmp: Path, kind: str = "closed", config: dict = TINY) -> Path:
    """A checkout-like root holding one cell, "tiny-<kind>", on the tiny configuration."""
    for d in ("benchmark/traffic", "benchmark/configs", "benchmark/limits"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(spec.BENCH_DIR / "metrics", tmp / "benchmark/metrics", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "benchmark/configs/tiny.json").write_text(json.dumps(config))
    (tmp / f"benchmark/traffic/tiny-{kind}.json").write_text(json.dumps(TRAFFIC[kind]))
    (tmp / f"benchmark/limits/tiny-{kind}.json").write_text(json.dumps(LIMITS))
    bench = {
        "command": ["python3", "-m", "benchmark.run"], "paths": ["benchmark"], "run_seconds": 3,
        "configs": [{"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json", "reduced": [],
                     "why": "test"}],
        "workloads": [{"name": f"tiny-{kind}", "config": "tiny", "traffic": f"tiny-{kind}", "chips": 1,
                       "why": "test"}],
        "end_to_end": [
            {"name": "images_per_s", "unit": "images/s", "better": "higher", "bound": 0.05, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"},
            {"name": "train_step_s", "unit": "s", "better": "lower", "bound": 0.05, "source": "host_clock"}],
        "per_layer": [
            {"name": "dit_step_ms.serve", "unit": "ms", "better": "lower", "source": "program_span",
             "layer": "DiT", "moves": "images_per_s"}],
    }
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
