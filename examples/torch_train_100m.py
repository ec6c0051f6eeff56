"""End-to-end training on the PyTorch port: train a ~100M-parameter model
for a few hundred steps with the full stack (packed data pipeline, AdamW
step, fault-tolerant supervisor with async checkpoints); the port of
``examples/train_100m.py``.

  PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] \\
      [--tiny] [--ckpt-dir DIR] [launcher arguments, e.g. --use-kernels \\
      --device cpu]

Uses a ~100M llama-family config (a scaled tinyllama, float32) through
``repro_torch.launch.train.main``; ``--tiny`` runs tinyllama's SMOKE
config instead, the same code path in seconds on the CPU. Arguments this
script does not know go to the launcher (``--use-kernels``, ``--device``,
``--ckpt-every``, ...). Without ``--ckpt-dir`` the checkpoints go to a
fresh temporary directory, deleted at the end; a run on a directory that
holds a checkpoint resumes from its latest step. The config registry is
left as found: llama-100m is registered for the launcher's call only.
Runs on the CUDA device unless ``--device cpu`` is passed.
"""
import argparse
import contextlib
import os
import sys
import tempfile
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import tinyllama_1_1b  # noqa: E402
from repro_torch.launch import train as train_main  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402

ARCH = "llama-100m"


def llama_100m():
    """The ~100M llama-family config: tinyllama scaled down, float32."""
    return tinyllama_1_1b.CONFIG.with_(
        name=ARCH, num_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=32000, dtype=torch.float32)


@contextlib.contextmanager
def registered(arch: str, cfg):
    """``configs.get_config(arch)`` (smoke or not) returns ``cfg`` inside
    the block, from a config module made for it; the registry and
    ``sys.modules`` are as found after it."""
    name = f"_example_{arch.replace('-', '_').replace('.', '_')}"
    module = types.ModuleType(f"repro_torch.configs.{name}")
    module.CONFIG = module.SMOKE = cfg
    sys.modules[module.__name__] = module
    configs._ARCHS[arch] = name
    try:
        yield
    finally:
        del configs._ARCHS[arch]
        del sys.modules[module.__name__]


def main(argv=None) -> dict:
    """Run the loop; returns the launcher's step records, the model's
    parameter count and the checkpoint directory used (deleted already
    when it was a temporary one)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="tinyllama's SMOKE config: seconds on the CPU")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, deleted at the end)")
    args, launcher_args = ap.parse_known_args(argv)

    if args.tiny:
        # same code path, seconds not hours on the CPU
        arch, cfg, smoke = "tinyllama-1.1b", None, True
        shape = ["--batch", "8", "--seq", "128"]
    else:
        arch, cfg, smoke = ARCH, llama_100m(), False
        shape = ["--batch", "4", "--seq", "512"]
    n_params = count_params(M.param_specs(
        cfg or configs.get_config(arch, smoke=True)))
    print(f"{arch}{' (SMOKE)' if smoke else ''}: {n_params / 1e6:.1f}M "
          "params")
    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="torch_train_100m_"))
        if cfg is not None:
            stack.enter_context(registered(arch, cfg))
        argv = (["--arch", arch] + (["--smoke"] if smoke else [])
                + ["--steps", str(args.steps)] + shape
                + ["--ckpt-dir", ckpt_dir, "--log-every", "10",
                   "--lr", "1e-3"] + launcher_args)
        history = train_main.main(argv)
    return {"history": history, "params": n_params, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
