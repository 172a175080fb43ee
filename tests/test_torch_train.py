"""Training of the PyTorch port against the JAX package, on the CPU (float32).

``models/llama.py::forward_train``, the loss and ``train/trainer.py::Trainer``
against JAX's ``forward_train``, ``loss_fn``, ``jax.grad`` and ``Trainer`` on
a one-device mesh; ``train/lora_trainer.py::LoraTrainer`` against JAX's
``LoraTrainer``. Both packages take the same params (``params_from_jax``) and
the same numpy-seeded tokens, on ``llama3-test`` and ``mixtral-test``. The
adapters start nonzero, so neither trainer draws its init.

Tolerances: logits and loss 1e-5; every gradient leaf 2e-6 absolute plus
1e-5 relative (f32 sums in another order; the largest error seen is 4e-7 on
gradients of about 0.4); rows the trainer must not touch, bit for bit.
Params after four Adam steps: within 1e-5 but for at most one element in a
thousand, and every element within 2 x lr x steps. Adam divides each moment
by its own root mean square, so an element whose gradient lies within f32
rounding of zero may step either way by up to lr (one element of 8,192 in
``llama3-test``'s wq moved 3e-5 apart at lr 1e-2); ``test_adam_equals_optax``
holds the update itself to 1e-5 of a step.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from runbookai_tpu.engine.engine import EngineConfig as JEngineConfig
from runbookai_tpu.engine.engine import EngineCore as JEngineCore
from runbookai_tpu.engine.request import EngineRequest as JRequest
from runbookai_tpu.engine.request import SamplingParams as JSampling
from runbookai_tpu.models import llama as jllama
from runbookai_tpu.models.lora import LoraRegistry as JLoraRegistry
from runbookai_tpu.models.quant import quantize_params as jquantize_params
from runbookai_tpu.parallel.mesh import build_mesh as jbuild_mesh
from runbookai_tpu.train import trainer as jtrainer
from runbookai_tpu.train.lora_trainer import LoraTrainer as JLoraTrainer
from runbookai_tpu.utils.tokens import ByteTokenizer as JByteTokenizer
from runbookai_tpu_torch.engine.engine import EngineConfig, EngineCore
from runbookai_tpu_torch.engine.request import EngineRequest, SamplingParams
from runbookai_tpu_torch.models import llama as tllama
from runbookai_tpu_torch.models.convert import lora_registry_from_jax, params_from_jax
from runbookai_tpu_torch.models.lora import LoraRegistry
from runbookai_tpu_torch.parallel.mesh import build_mesh
from runbookai_tpu_torch.train import trainer as ttrainer
from runbookai_tpu_torch.train.lora_trainer import LoraTrainer
from runbookai_tpu_torch.utils.tokens import ByteTokenizer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

NAMES = ("llama3-test", "mixtral-test")
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=2e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
ADAM_FLIPS = 1e-3  # the share of a leaf's elements allowed past PARAM_TOL
RANK = 4
STEPS = 4
TOK = ByteTokenizer()
AFTER = "rollback payment-api?"  # the prompt served after publish


def _tokens(seed: int, shape=(2, 13)) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 262, shape)


def _named(tree, prefix=""):
    """``{path: leaf}`` of a nested dict, paths joined with dots."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _named(sub, f"{prefix}{name}.").items()}
    return {prefix[:-1]: tree}


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _weights(name: str):
    """(name, JAX params, the port's params) from JAX's init at seed 0."""
    jparams = jllama.init_params(jax.random.PRNGKey(0), jllama.CONFIGS[name],
                                 dtype=jnp.float32)
    return name, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    return _weights(request.param)


def assert_adam_close(got: np.ndarray, want: np.ndarray, lr: float, what: str) -> None:
    """``got`` within PARAM_TOL of ``want`` but for at most ADAM_FLIPS of its
    elements, each of them within 2 x lr x STEPS (see the module's note)."""
    close = np.isclose(got, want, **PARAM_TOL)
    assert close.mean() >= 1 - ADAM_FLIPS, (what, int((~close).sum()))
    assert np.abs(got - want).max() <= 2 * lr * STEPS, what


# ------------------------------------------------------- forward and grads


def test_forward_train_and_loss_match_jax(model):
    name, jparams, tparams = model
    tokens = _tokens(1)
    want = jllama.forward_train(jparams, jllama.CONFIGS[name], jnp.asarray(tokens[:, :-1]))
    got = tllama.forward_train(tparams, tllama.CONFIGS[name], torch.as_tensor(tokens[:, :-1]))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 262)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    # A pad target (id 0 here) drops out of the mean.
    tokens[0, 5:] = 0
    jloss = jtrainer.loss_fn(jparams, jllama.CONFIGS[name], jnp.asarray(tokens), 0)
    tloss = ttrainer.loss_fn(tparams, tllama.CONFIGS[name], torch.as_tensor(tokens), 0)
    np.testing.assert_allclose(float(tloss), float(jloss), **LOGIT_TOL)


def test_every_gradient_matches_jax_grad(model):
    """``jax.grad`` of JAX's loss against autograd through the port's, for
    every leaf; the rematerialised backward gives the same gradients bit
    for bit."""
    name, jparams, tparams = model
    tokens = _tokens(2)
    want = _named(jax.tree.map(np.asarray, jax.grad(jtrainer.loss_fn)(
        jparams, jllama.CONFIGS[name], jnp.asarray(tokens), 0)))
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), tparams)
    leaves = _named(params)
    assert set(leaves) == set(want)
    grads = {}
    for remat in (False, True):
        loss = ttrainer.loss_fn(params, tllama.CONFIGS[name], torch.as_tensor(tokens), 0,
                                remat=remat)
        grads[remat] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for path, g in grads[False].items():
        np.testing.assert_allclose(_np(g), want[path], err_msg=path, **GRAD_TOL)
        assert torch.equal(g, grads[True][path]), path


def test_adam_equals_optax():
    """``Adam`` against ``optax.adamw`` (weight decay on every leaf) and
    ``optax.adam`` over five steps of random gradients, a zero-gradient leaf
    included: equal within 1e-6 relative plus 1e-5 of a step (``torch.sqrt``
    on the CPU is not correctly rounded, XLA's is), the zero leaf unchanged."""
    rng = np.random.default_rng(3)
    shapes = [(5, 7), (3,), (2, 4, 6)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    for wd, tx in ((0.01, optax.adamw(1e-2, weight_decay=0.01)), (0.0, optax.adam(3e-3))):
        lr = 1e-2 if wd else 3e-3
        jp = [jnp.asarray(p) for p in params]
        state = tx.init(jp)
        leaves = [torch.from_numpy(p.copy()) for p in params]
        opt = ttrainer.Adam(leaves, lr, weight_decay=wd)
        for step in range(5):
            grads = [rng.normal(size=s).astype(np.float32) * 10.0 ** -step for s in shapes]
            grads[1] = np.zeros_like(grads[1])
            updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
            jp = optax.apply_updates(jp, updates)
            opt.step([torch.from_numpy(g) for g in grads])
        for a, b in zip(jp, leaves):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-5 * lr)
        if not wd:
            assert np.array_equal(leaves[1].numpy(), params[1])


# ----------------------------------------------------------------- Trainer


def test_trainer_matches_jax_trainer(model):
    """Four steps of the port's ``Trainer`` from JAX's initial params against
    JAX's ``Trainer`` on a one-device mesh: the losses and every param."""
    name, _, _ = model
    jt = jtrainer.Trainer(jllama.CONFIGS[name], jbuild_mesh(1, 1), learning_rate=1e-2)
    start = jax.tree.map(np.asarray, jt.state.params)
    tt = ttrainer.Trainer(tllama.CONFIGS[name], learning_rate=1e-2, device="cpu")
    with torch.no_grad():
        for path, leaf in _named(tt.state.params).items():
            leaf.copy_(torch.from_numpy(np.array(_named(start)[path])))
    tokens = _tokens(4, (4, 17))
    want = [jt.train_step(tokens) for _ in range(STEPS)]
    got = [tt.train_step(tokens) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert got[-1] < got[0] and tt.state.step == jt.state.step == STEPS
    jafter = _named(jax.tree.map(np.asarray, jt.state.params))
    for path, leaf in _named(tt.state.params).items():
        assert_adam_close(_np(leaf), jafter[path], 1e-2, path)


def test_trainer_draws_its_params_and_refuses_a_mesh():
    """Params from ``torch.Generator(seed)`` in ``dtype`` (f32 by default),
    the same for the same seed; any mesh axis over 1 is multi-card training."""
    cfg = tllama.CONFIGS["llama3-test"]
    a, b = (ttrainer.Trainer(cfg, seed=s, device="cpu") for s in (0, 0))
    c = ttrainer.Trainer(cfg, seed=1, device="cpu", dtype=torch.bfloat16)
    assert a.state.params["embed"].dtype == torch.float32
    assert c.state.params["embed"].dtype == torch.bfloat16
    assert torch.equal(a.state.params["embed"], b.state.params["embed"])
    assert not torch.equal(a.state.params["embed"].bfloat16(), c.state.params["embed"])
    ttrainer.Trainer(cfg, mesh=build_mesh(1, 1, ["cpu"]), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        ttrainer.Trainer(cfg, mesh=build_mesh(2, 1, ["cpu"] * 2), device="cpu")


# ------------------------------------------------------------- LoraTrainer


def _rand_adapter(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    outs = {"wq": cfg.n_heads * cfg.head_dim, "wv": cfg.n_kv_heads * cfg.head_dim}
    return {t: {"A": rng.normal(size=(cfg.n_layers, cfg.dim, RANK)) * 0.3,
                "B": rng.normal(size=(cfg.n_layers, RANK, out)) * 0.3}
            for t, out in outs.items()}


def _registries(name: str):
    jreg = JLoraRegistry(jllama.CONFIGS[name], rank=RANK, targets=("wq", "wv"),
                         dtype=jnp.float32)
    for i in range(2):
        jreg.register(f"adapter{i}", _rand_adapter(jllama.CONFIGS[name], 100 + i))
    return jreg, lora_registry_from_jax(jreg, tllama.CONFIGS[name], device="cpu",
                                        dtype=torch.float32)


def _greedy_t(core, adapter, prompt="deploy status?", n=8):
    req = EngineRequest(prompt_ids=TOK.encode(prompt),
                        sampling=SamplingParams(max_new_tokens=n, stop_token_ids=()),
                        adapter=adapter)
    core.submit(req)
    core.run_until_idle()
    return req.out_ids


def _tcore(name, params, reg):
    return EngineCore(tllama.CONFIGS[name], params, TOK, EngineConfig(
        page_size=4, num_pages=128, max_batch_slots=4, prefill_chunk=16, max_seq_len=128,
        kv_dtype=torch.float32, speculative=False), lora_registry=reg)


@pytest.fixture(scope="module")
def llama():
    return _weights("llama3-test")


@pytest.mark.parametrize("name,int8", [("llama3-test", False), ("llama3-test", True),
                                       ("mixtral-test", False)],
                         ids=["llama_f32_base", "llama_int8_base", "mixtral_f32_base"])
def test_lora_trainer_matches_jax(name, int8, tmp_path, monkeypatch):
    """Four steps on ``adapter1`` from the same nonzero adapters over the same
    base (int8: JAX's ``quantize_params``): losses and the trained rows
    against JAX's; the zero row and ``adapter0`` bit for bit as they were;
    the base never launches the int8 kernel; ``publish`` writes only that
    row; an engine's ``refresh_lora`` then serves what a fresh registry
    loading ``export_peft``'s directory serves, and JAX's registry reads the
    directory as it reads JAX's own export."""
    _, jparams, tparams = _weights(name)
    if int8:
        jparams = jquantize_params(jparams)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jreg, treg = _registries(name)
    before = {t: {ab: w.clone() for ab, w in ab_w.items()} for t, ab_w in treg.stacked().items()}
    core = _tcore(name, tparams, treg)  # a live engine, serving before training
    _greedy_t(core, "adapter1")
    jt = JLoraTrainer(jllama.CONFIGS[name], jparams, jreg, "adapter1", learning_rate=3e-3,
                      pad_id=0)
    tt = LoraTrainer(tllama.CONFIGS[name], tparams, treg, "adapter1", learning_rate=3e-3,
                     pad_id=0)
    assert tt.lora_tree["wq"]["A"].data_ptr() != treg.stacked()["wq"]["A"].data_ptr()
    tokens = _tokens(5, (4, 24))
    want = [jt.train_step(tokens) for _ in range(STEPS)]
    with monkeypatch.context() as m:  # the base's int8 products never reach K5
        m.setattr(tllama, "qmm_int8", lambda *a: pytest.fail("K5 in a training step"))
        got = [tt.train_step(tokens) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert got[-1] < got[0]
    for t in ("wq", "wv"):
        for ab in ("A", "B"):
            trained = tt.lora_tree[t][ab].detach()
            assert_adam_close(trained[:, 2].numpy(), np.asarray(jt.lora_tree[t][ab][:, 2]),
                              3e-3, f"{t}.{ab}")
            assert torch.equal(trained[:, :2], before[t][ab][:, :2])
            assert not torch.equal(trained[:, 2], before[t][ab][:, 2])
            assert torch.equal(treg.stacked()[t][ab], before[t][ab])  # not aliased
    tt.publish()
    stacked = treg.stacked()
    for t in ("wq", "wv"):
        for ab in ("A", "B"):
            assert torch.equal(stacked[t][ab][:, 2], tt.lora_tree[t][ab][:, 2].detach())
            assert torch.equal(stacked[t][ab][:, :2], before[t][ab][:, :2])
    # Pages cached under the row before publish keep its old K/V (as in the
    # JAX engine): the published adapter is asked a prompt it has not seen.
    core.refresh_lora()
    published = _greedy_t(core, "adapter1", AFTER)
    untrained = _greedy_t(_tcore(name, tparams, lora_registry_from_jax(
        jreg, tllama.CONFIGS[name], device="cpu", dtype=torch.float32)), "adapter1", AFTER)
    assert published != untrained

    tt.export_peft(tmp_path / "port")
    jt.export_peft(str(tmp_path / "jax"))
    assert json.loads((tmp_path / "port" / "adapter_config.json").read_text()) == \
        json.loads((tmp_path / "jax" / "adapter_config.json").read_text())
    reg2 = LoraRegistry(tllama.CONFIGS[name], rank=RANK, targets=("wq", "wv"),
                        dtype=torch.float32, device="cpu")
    reg2.load_peft_dir("tuned", tmp_path / "port")
    for t in ("wq", "wv"):
        for ab in ("A", "B"):
            assert torch.equal(reg2.stacked()[t][ab][:, 1], stacked[t][ab][:, 2])
    assert _greedy_t(_tcore(name, tparams, reg2), "tuned", AFTER) == published
    jfrom = {}
    for d in ("port", "jax"):
        r = JLoraRegistry(jllama.CONFIGS[name], rank=RANK, targets=("wq", "wv"),
                          dtype=jnp.float32)
        r.load_peft_dir("tuned", str(tmp_path / d))
        jfrom[d] = jax.tree.map(np.asarray, r.stacked())
    for t in ("wq", "wv"):
        for ab in ("A", "B"):
            np.testing.assert_allclose(jfrom["port"][t][ab], jfrom["jax"][t][ab], **PARAM_TOL)


def test_lora_trainer_publish_serves_like_jax(llama):
    """After the same steps, JAX's engine serving its published adapter and
    the port's serving its own give the same greedy tokens."""
    name, jparams, tparams = llama
    jreg, treg = _registries(name)
    jt = JLoraTrainer(jllama.CONFIGS[name], jparams, jreg, "adapter0", learning_rate=1e-2)
    tt = LoraTrainer(tllama.CONFIGS[name], tparams, treg, "adapter0", learning_rate=1e-2)
    tokens = _tokens(6, (2, 16))
    for _ in range(2):
        jt.train_step(tokens)
        tt.train_step(tokens)
    jt.publish()
    tt.publish()
    jcore = JEngineCore(jllama.CONFIGS[name], jparams, JByteTokenizer(), JEngineConfig(
        page_size=4, num_pages=128, max_batch_slots=4, prefill_chunk=16, max_seq_len=128,
        kv_dtype=jnp.float32, block_pages=8, speculative=False), lora_registry=jreg)
    req = JRequest(prompt_ids=JByteTokenizer().encode("deploy status?"),
                   sampling=JSampling(max_new_tokens=8, stop_token_ids=()), adapter="adapter0")
    jcore.submit(req)
    jcore.run_until_idle()
    assert _greedy_t(_tcore(name, tparams, treg), "adapter0") == req.out_ids


def test_lora_trainer_breaks_the_zero_saddle():
    """A freshly registered (all-zero) adapter: A drawn as N(0, 1/in), B
    zero, the loss falls, every other row stays as it was."""
    name = "llama3-test"
    cfg = tllama.CONFIGS[name]
    _, treg = _registries(name)
    treg.register("fresh", {})
    before = {t: {ab: w.clone() for ab, w in ab_w.items()} for t, ab_w in treg.stacked().items()}
    tparams = tllama.init_params(cfg, dtype=torch.float32, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    tt = LoraTrainer(cfg, tparams, treg, "fresh", learning_rate=3e-3)
    a = tt.lora_tree["wq"]["A"][:, 3].detach()
    assert not torch.any(tt.lora_tree["wq"]["B"][:, 3])
    assert 0.5 < float(a.std() * cfg.dim ** 0.5) < 1.5
    tokens = _tokens(7, (4, 24))
    losses = [tt.train_step(tokens) for _ in range(10)]
    assert losses[-1] < losses[0] - 1e-4
    for t in ("wq", "wv"):
        for ab in ("A", "B"):
            assert torch.equal(tt.lora_tree[t][ab][:, :3].detach(), before[t][ab][:, :3])
