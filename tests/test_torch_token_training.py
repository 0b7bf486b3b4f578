"""The token policies' training pass against the JAX package's (CPU, fp32).

Eight reduced configs (qwen2-7b, minicpm3-4b, dbrx-132b, deepseek-v2-236b,
pixtral-12b with 8 patch embeddings before the text,
seamless-m4t-large-v2 with 16 frames through its encoder, mamba2-370m and
zamba2-7b, one group of 2 Mamba2 layers and the shared block), and
zamba2-7b at 3 layers (a group and a tail layer, remat "full") over 64
tokens (two chunks of 32), are initialised in JAX and carried across with
``params_from_numpy``; the same numpy batch goes through both sides. The
Mamba2 layers' gradients go through K6's plain backward
(``ops.SSDScan``).

* ``policy_apply(train=True)``: logits and values within 1e-4 (absolute
  and relative; the trunks' tolerance in ``tests/test_torch_models.py``)
  and the MoE aux loss within 1e-5.
* One ``make_llm_train_step`` with RMSProp: the loss and each metric
  within 1e-5 (relative), every gradient within 1e-4 of its leaf's largest
  reference value (taken out of the optimizer, which hands it on), and
  every parameter after the update within 1e-5. Dones at a 20% rate, so
  the returns' bootstrap gradient is cut where the reference's is.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.agents.paac import PAACAgent as JaxPAAC  # noqa: E402
from repro.core.agents.paac import PAACConfig as JaxPAACConfig  # noqa: E402
from repro.models import init_policy as jax_init  # noqa: E402
from repro.models import policy_apply as jax_apply  # noqa: E402
from repro.optim import Optimizer as JaxOptimizer  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.agents.paac import PAACAgent, PAACConfig  # noqa: E402
from repro_torch.models import policy_apply  # noqa: E402
from repro_torch.optim import Optimizer, constant, make_optimizer  # noqa: E402
from repro_torch.utils.bridge import params_from_numpy, params_to_numpy  # noqa: E402

ARCHS = ["qwen2-7b", "minicpm3-4b", "dbrx-132b", "deepseek-v2-236b",
         "pixtral-12b", "seamless-m4t-large-v2", "mamba2-370m", "zamba2-7b"]
# (case, arch, config changes, T): each reduced arch at T 16, and the
# hybrid with a tail layer and remat over two chunks
CASES = [(arch, arch, {}, 16) for arch in ARCHS] + [
    ("zamba2-7b-3-layers", "zamba2-7b", {"num_layers": 3, "remat": "full"},
     64)]
APPLY_TOL = 1e-4
AUX_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
LR = 1e-3
B = 2

_PAIRS = {}


def _pair(case):
    """(jax cfg, torch cfg, jax params, torch params, numpy batch)."""
    if case not in _PAIRS:
        arch, change, T = next((a, c, t) for n, a, c, t in CASES
                               if n == case)
        cfg_j = jax_config(arch).reduced().replace(**change)
        cfg = get_config(arch).reduced().replace(**change)
        pj = jax_init(jax.random.PRNGKey(0), cfg_j)
        pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
        rng = np.random.default_rng(0)
        batch = {
            "tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)
                                   ).astype(np.int32),
            "rewards": rng.random((B, T), dtype=np.float32),
            "dones": rng.random((B, T)) < 0.2,
        }
        if cfg.modality == "vision":
            batch["prefix"] = rng.standard_normal(
                (B, cfg.prefix_len, cfg.frontend_dim), dtype=np.float32)
        if cfg.is_encoder_decoder:
            batch["frames"] = rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.frontend_dim), dtype=np.float32)
        _PAIRS[case] = (cfg_j, cfg, pj, pt, batch)
    return _PAIRS[case]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _prefix(batch):
    return batch.get("prefix", batch.get("frames"))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_policy_apply_train_matches_the_reference(case):
    cfg_j, cfg, pj, pt, batch = _pair(case)
    tokens = batch["tokens"][:, :-1]
    T = tokens.shape[1]
    pre = _prefix(batch)
    lj, vj, aj = jax_apply(pj, cfg_j, jnp.asarray(tokens),
                           None if pre is None else jnp.asarray(pre),
                           train=True)
    lt, vt, at = policy_apply(pt, cfg, torch.from_numpy(tokens),
                              None if pre is None else torch.from_numpy(pre),
                              train=True)
    S = T + (cfg.prefix_len if cfg.modality == "vision" else 0)
    assert tuple(lt.shape) == (B, S, cfg.actions()) == tuple(lj.shape)
    assert lt.dtype == vt.dtype == torch.float32
    _close(lt.detach(), lj, APPLY_TOL)
    _close(vt.detach(), vj, APPLY_TOL)
    assert set(at) == set(aj) == {"moe_aux"}
    _close(at["moe_aux"].detach(), aj["moe_aux"], AUX_TOL)
    if cfg.num_experts:
        assert float(at["moe_aux"]) > 0.0


def _capturing(opt, xp):
    """``opt`` whose update also hands back the gradients it was given,
    beside the state (the same construction on both sides)."""

    def update(grads, state, params, lr):
        params, state = opt.update(grads, state, params, lr)
        return params, {"inner": state, "grads": grads}

    return (JaxOptimizer if xp == "jax" else Optimizer)(opt.init, update)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_llm_train_step_matches_the_reference(case):
    cfg_j, cfg, pj, pt, batch = _pair(case)
    jopt = _capturing(jax_make_optimizer("rmsprop"), "jax")
    jstep = jax.jit(JaxPAAC(cfg_j, JaxPAACConfig()).make_llm_train_step(
        jopt, jax_constant(LR)))
    pj_new, sj, mj = jstep(pj, jopt.init(pj),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.int32(0))
    topt = _capturing(make_optimizer("rmsprop"), "torch")
    tstep = PAACAgent(cfg, PAACConfig()).make_llm_train_step(topt,
                                                             constant(LR))
    pt_new, st, mt = tstep(pt, topt.init(pt),
                           {k: torch.from_numpy(np.asarray(v))
                            for k, v in batch.items()}, 0)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)
    assert np.isfinite(float(mt["loss"]))
    gj = jax.tree_util.tree_leaves(_np_tree(sj["grads"]))
    gt = jax.tree_util.tree_leaves(params_to_numpy(st["grads"]))
    assert len(gj) == len(gt)
    for a, b in zip(gt, gj):
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0,
                                   atol=GRAD_TOL)
    new_j = jax.tree_util.tree_leaves(_np_tree(pj_new))
    new_t = jax.tree_util.tree_leaves(params_to_numpy(pt_new))
    old = jax.tree_util.tree_leaves(_np_tree(pj))
    for a, b in zip(new_t, new_j):
        _close(a, b, PARAM_TOL)
    assert max(float(np.abs(a - b).max()) for a, b in zip(new_t, old)) > 0


def test_the_moe_aux_loss_carries_a_gradient_to_the_router():
    """The Switch aux loss reaches the router through the mean router
    probabilities; routing and capacity drops stay discrete."""
    _, cfg, _, pt, batch = _pair("dbrx-132b")
    router = pt["trunk"]["layers"]["moe"]["router"]["w"]
    w = router.detach().requires_grad_(True)
    tree = {**pt, "trunk": {**pt["trunk"], "layers": {
        **pt["trunk"]["layers"], "moe": {**pt["trunk"]["layers"]["moe"],
                                         "router": {"w": w}}}}}
    _, _, aux = policy_apply(tree, cfg,
                             torch.from_numpy(batch["tokens"][:, :-1]),
                             train=True)
    (g,) = torch.autograd.grad(aux["moe_aux"], [w])
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
