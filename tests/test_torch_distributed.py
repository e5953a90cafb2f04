"""The port's sharded path (DTensor params, ``local_map`` bodies, explicit
collectives) against the JAX package and against the port's own
single-device path.

The multi-rank checks run once, in one subprocess: tests/_torch_world.py,
a 4-process gloo world with mesh (data 2, model 2) rendezvousing through a
``FileStore`` under ``tmp_path`` (about 45 s). Its results:

- (a) expert-parallel MoE (``_moe_block`` through ``moe_ffn_ep_local`` in
  ``local_map``, all-to-all over 'data', F split over 'model') on
  ``dbrx-132b.reduced()`` with a capacity that drops nothing, against
  JAX's single-device ``moe_ffn`` computed here: outputs within 5e-4,
  gradients of ``sum(out**2)`` within atol = rtol = 2e-3 (the bounds of
  tests/test_distributed.py's EP test);
- (b) one ``build_train_step(cfg, mesh)`` step against
  ``build_train_step(cfg)`` on six ``.reduced()`` configs, from the same
  weights and batch: the loss and every gradient leaf that each step's
  ``loss_and_grads`` gives (loss within 1e-5 relative, each leaf within
  1e-4 of its largest magnitude), the step's loss (1e-5 relative) and
  every updated param (within 2 lr(0) + 1e-6 absolute, the most a first
  AdamW step, which moves each weight by about lr times the sign of its
  gradient, can part two runs whose gradients differ by rounding). The
  JAX package's own sharded-step test is red (ROADMAP), so the port is
  held against itself here;
- (c) the prefill step and two decode steps under the mesh give the greedy
  tokens of the steps without it;
- (d) a checkpoint saved on the (2, 2) mesh restores onto (data 4, model
  1) and onto one device bit for bit;
- the paged functions (``lm_prefill_paged``, then ``lm_decode_paged`` with
  an idle lane) on a pool split over the heads, and gemma2's decode on a
  cache split on its sequence (the long-context layout) or on its head
  dim ((1, 4) mesh): logits and caches within 1e-5 of their largest
  magnitude of the single-device ones.

On the CPU without a mesh: ``lm_forward`` with per-row positions against
JAX's (1e-4), and ``launch.train.train(device="cpu")`` (a world of one
rank of its own, a (1, 1) mesh) against the single-device step loop, loss
for loss equal.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import layers as jL
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtf
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_world as world  # noqa: E402

LR0 = 3e-4 / 100                     # OptConfig's lr at step 0 (warmup)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("world")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    run = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__),
                                      "_torch_world.py"), str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-6000:]
    with open(out / "results.json") as f:
        res = json.load(f)
    res["ep"] = dict(np.load(out / "ep.npz"))
    return res


def test_world_is_a_2x2_mesh(results):
    assert results["mesh"] == {"data": 2, "model": 2}


def test_ep_moe_matches_jax_moe_ffn(results):
    ep = results["ep"]
    jcfg = world.no_drop(jget_config("dbrx-132b").reduced())
    p = {k: jnp.asarray(ep[k]) for k in ("router", "w_gate", "w_up",
                                         "w_down")}
    x = jnp.asarray(ep["x"])
    want = jax.jit(lambda q: jL.moe_ffn(jcfg, q, x))(p)
    assert float(np.max(np.abs(ep["out"] - np.asarray(want)))) < 5e-4
    grads = jax.jit(jax.grad(
        lambda q: jnp.sum(jL.moe_ffn(jcfg, q, x) ** 2)))(p)
    for k, g in grads.items():
        np.testing.assert_allclose(ep["grad_" + k], np.asarray(g),
                                   atol=2e-3, rtol=2e-3, err_msg=k)


@pytest.mark.parametrize("arch", world.TRAIN_ARCHS)
def test_sharded_train_step_matches_single_device(results, arch):
    r = results["train " + arch]
    assert r["sharded_leaves"] > 0
    assert r["loss"] <= 1e-5, r
    assert r["grad"] <= 1e-4, r
    assert r["step_loss"] <= 1e-5, r
    assert r["step_params"] <= 2 * LR0 + 1e-6, r


@pytest.mark.parametrize("arch", world.TRAIN_ARCHS)
def test_sharded_prefill_and_decode_tokens_match(results, arch):
    assert all(results["serve " + arch]["tokens_equal"]), results


def test_sharded_paged_prefill_and_decode_match(results):
    r = results["paged"]
    assert max(r.values()) <= 1e-5, r


@pytest.mark.parametrize("split", ["seq", "head_dim"])
def test_split_cache_decode_matches(results, split):
    r = results["split_cache"][split]
    assert r["logits"] <= 1e-5 and r["cache"] <= 1e-5, r
    assert r["split"] == {"seq": ["S(2)", "S(3)"],
                          "head_dim": ["S(1)", "S(4)"]}[split]


def test_checkpoint_restores_across_meshes_bit_exactly(results):
    r = results["checkpoint"]
    assert r == {"step": 3, "exact_4x1": True, "exact_1": True,
                 "on_4x1": True}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-27b"])
def test_lm_forward_positions_match_jax(arch):
    """Rows at their own offsets (row b at 7 b, 7 b + 1, ...), which the
    flash kernel's one host offset cannot take: the plain attention."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    jparams = jzoo.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32)
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (3, 24),
                                             dtype=np.int32)
    pos = (np.arange(24, dtype=np.int32)[None]
           + 7 * np.arange(3, dtype=np.int32)[:, None])
    got = ttf.lm_forward(cfg, tparams, torch.from_numpy(toks),
                         positions=torch.from_numpy(pos))
    want = jax.jit(lambda p, t, q: jtf.lm_forward(jcfg, p, t, positions=q))(
        jparams, jnp.asarray(toks), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_trainer_in_a_world_of_one_gives_the_single_device_losses():
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import model_zoo
    from repro_torch.train.data import DataConfig, SyntheticLMStream
    from repro_torch.train.optimizer import OptConfig, init_opt
    steps, S, Bt = 6, 32, 2
    losses, _ = train("llama3.2-1b", steps=steps, seq_len=S, batch=Bt,
                      verbose=False, device="cpu")
    cfg = get_config("llama3.2-1b").reduced()
    params = model_zoo.init(cfg, 0, torch.float32, device="cpu")
    opt_state = init_opt(params)
    data = SyntheticLMStream(DataConfig(cfg.vocab_size, S, Bt))
    step = build_train_step(cfg, opt=OptConfig(total_steps=steps,
                                               warmup_steps=1), remat=False)
    want = []
    for _ in range(steps):
        toks, tgts = data.next_batch()
        params, opt_state, m = step(params, opt_state, {
            "tokens": torch.from_numpy(toks),
            "targets": torch.from_numpy(tgts)})
        want.append(float(m["loss"]))
    assert losses == want
    assert not torch.distributed.is_initialized()
