"""The port's serving engine against the JAX package's: the same weights
(carried across by ``from_reference``), the same requests, greedy, float32
— identical token lists, with the JAX prefill running its Pallas
``flash_attention`` in interpret mode. Plus continuous batching, the
engine against a hand-rolled prefill + decode loop, and the CLI."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import model as MJ
from repro.serve import engine as engine_jax
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

from _torch_threads import one_thread_env
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _requests(lengths, vocab, seed):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(2, vocab, n).astype(np.int32))
            for uid, n in enumerate(lengths)]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b"])
def test_engine_matches_jax_engine(arch):
    """Two slots, five requests of 3..150 tokens (prefill buckets 128 and
    256, gemma2's 16-token window inside them): the same greedy tokens."""
    cfg_j = jax_configs.get_config(arch, smoke=True).with_(use_kernels=True)
    cfg_t = configs.get_config(arch, smoke=True).with_(use_kernels=True)
    params_j = MJ.init(jax.random.PRNGKey(0), cfg_j)
    params_t = P.from_reference(jax.tree.map(np.asarray, params_j), cfg_t,
                                "cpu")
    kw = dict(slots=2, max_seq=256, max_new_tokens=6)
    eng_j = engine_jax.ServingEngine(params_j, cfg_j,
                                     engine_jax.ServeConfig(**kw))
    eng_t = ServingEngine(params_t, cfg_t, ServeConfig(**kw), device="cpu")
    for uid, prompt in _requests([72, 3, 150, 129, 21], cfg_t.vocab_size,
                                     seed=1):
        eng_j.submit(engine_jax.Request(uid=uid, prompt=prompt))
        eng_t.submit(Request(uid=uid, prompt=prompt))
    want = eng_j.run_to_completion()
    jax.clear_caches()
    got = eng_t.run_to_completion()
    assert got == want
    assert all(1 <= len(v) <= 6 for v in got.values())


def test_serving_continuous_batching():
    cfg = configs.get_config("tinyllama-1.1b", smoke=True)
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(params, cfg,
                        ServeConfig(slots=2, max_seq=128, max_new_tokens=6),
                        device="cpu")
    for uid, prompt in _requests([7] * 5, cfg.vocab_size, seed=0):
        eng.submit(Request(uid=uid, prompt=prompt))  # more than the slots
    out = eng.run_to_completion()
    assert len(out) == 5
    assert all(1 <= len(v) <= 6 for v in out.values())


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_serving_matches_direct_decode(temperature):
    """Engine output == a hand-rolled prefill + decode loop: greedy, and
    sampling with a generator seeded alike."""
    cfg = configs.get_config("tinyllama-1.1b", smoke=True)
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = np.asarray([5, 9, 17, 33, 2, 8], np.int32)

    eng = ServingEngine(params, cfg,
                        ServeConfig(slots=1, max_seq=64, max_new_tokens=5,
                                    temperature=temperature, eos_id=-1),
                        device="cpu", generator=torch.Generator().manual_seed(9))
    eng.submit(Request(uid=0, prompt=prompt))
    got = eng.run_to_completion()[0]

    gen = torch.Generator().manual_seed(9)
    cache = M.init_cache(cfg, 1, 64, device="cpu")
    _, cache = M.prefill(params, {"tokens": torch.from_numpy(prompt)[None]},
                         cfg, cache)
    want, cur, pos = [], int(prompt[-1]), len(prompt) - 1
    for _ in range(5):
        lg, cache = M.decode_step(params, torch.tensor([[cur]]), pos, cfg,
                                  cache)
        lg = lg[0, 0, :cfg.vocab_size]
        if temperature:
            probs = torch.softmax(lg / temperature, dim=-1)
            cur = int(torch.multinomial(probs[None], 1, generator=gen))
        else:
            cur = int(torch.argmax(lg))
        want.append(cur)
        pos += 1
    assert got == want


def test_entry_points_default_to_the_card():
    """Without ``device`` the port runs on CUDA, and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = configs.get_config("tinyllama-1.1b", smoke=True)
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    for call in (lambda: M.init(cfg), lambda: M.init_cache(cfg, 1, 8),
                 lambda: ServingEngine(params, cfg, ServeConfig())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_serve_cli_on_the_cpu():
    env = one_thread_env(PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert '"requests": 8' in proc.stdout
