"""Weight checkpoints of the PyTorch port (``models/checkpoint.py``,
``python -m runbookai_tpu_torch weights convert|info``) against the JAX
package's, on the CPU, after ``tests/test_checkpoint_trace.py``.

The port writes ``config.json`` as the JAX package does (the same text) and
the tree as one safetensors file (the JAX package writes orbax, which the
port cannot read: it refuses a JAX checkpoint by name). Round trips are bit
for bit; a restored model's logits equal JAX's ``forward_train`` of the
params it saved within 1e-5 (f32); the CLI prints what the JAX CLI prints,
the checkpoint paths aside.
"""

import asyncio
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import runbookai_tpu.cli.main as j_main
import runbookai_tpu_torch.__main__ as t_main
from runbookai_tpu.models import checkpoint as jckpt
from runbookai_tpu.models import llama as jllama
from runbookai_tpu_torch.model.torch_cuda import TorchCudaClient
from runbookai_tpu_torch.models import checkpoint as ckpt
from runbookai_tpu_torch.models import llama as tllama
from runbookai_tpu_torch.models.convert import params_from_jax
from runbookai_tpu_torch.models.checkpoint import load_or_init
from runbookai_tpu_torch.models.hf_loader import load_params, read_safetensors, write_safetensors
from runbookai_tpu_torch.models.quant import is_quantized, quantize_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)  # several workers share the cores

FIXTURES = Path(__file__).parent / "fixtures"
CFG = tllama.CONFIGS["llama3-test"]
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _named(sub, f"{prefix}{name}.").items()}
    return {prefix[:-1]: tree}


def assert_trees_equal(a, b) -> None:
    a, b = _named(a), _named(b)
    assert a.keys() == b.keys()
    for path, x in a.items():
        assert x.dtype == b[path].dtype and torch.equal(x, b[path]), path


def _jparams(name="llama3-test", cfg=None, seed=0):
    return jllama.init_params(jax.random.PRNGKey(seed), cfg or jllama.CONFIGS[name],
                              dtype=jnp.float32)


def _params(quant=False, jparams=None):
    p = params_from_jax(jax.tree.map(np.asarray, _jparams() if jparams is None else jparams),
                        device="cpu")
    return quantize_params(p) if quant else p


# ------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_checkpoint_roundtrip_plain_and_quantized(quant, tmp_path):
    params = _params(quant)
    path = ckpt.save_checkpoint(tmp_path / "ck", CFG, params)
    assert ckpt.is_checkpoint(path) and not ckpt.is_jax_checkpoint(path)
    assert ckpt.checkpoint_config(path) == CFG
    jpath = jckpt.save_checkpoint(tmp_path / "jax", jllama.CONFIGS["llama3-test"],
                                  _jparams())
    assert (path / "config.json").read_text() == (jpath / "config.json").read_text()
    cfg2, restored = ckpt.load_checkpoint(path, device="cpu")
    assert cfg2 == CFG
    assert is_quantized(restored["layers"]["wq"]) == quant
    assert_trees_equal(params, restored)


def test_load_or_init_detects_checkpoint_dir(tmp_path):
    """A checkpoint directory is restored before HF parsing, int8 leaves as
    written; ``dtype`` casts only floating leaves that are not f32; int8 is
    applied on load to an unquantized checkpoint."""
    params = _params(quant=True)
    path = ckpt.save_checkpoint(tmp_path / "ck", CFG, params)
    cfg, loaded = load_or_init("llama3-test", path, dtype=torch.bfloat16, device="cpu")
    assert cfg == CFG
    assert_trees_equal(params, loaded)  # f32 leaves stay f32, int8 stays int8

    bf16 = {**params, "embed": params["embed"].bfloat16()}
    path = ckpt.save_checkpoint(tmp_path / "bf16", CFG, bf16)
    _, loaded = load_or_init("llama3-test", path, dtype=torch.float32, device="cpu")
    assert loaded["embed"].dtype == torch.float32
    assert torch.equal(loaded["embed"], bf16["embed"].float())
    assert loaded["layers"]["wq"]["q"].dtype == torch.int8

    plain = _params()
    path = ckpt.save_checkpoint(tmp_path / "plain", CFG, plain)
    _, loaded = load_or_init("llama3-test", path, dtype=torch.float32, device="cpu",
                             quantize_int8=True)
    assert_trees_equal(quantize_params(plain), loaded)


def test_client_serves_a_checkpoint_as_its_params(tmp_path):
    """``TorchCudaClient.build(model_path=checkpoint)`` takes the checkpoint's
    config and params: its greedy stream is the stream of a client over the
    params themselves, also cut over a tensor-parallel mesh after loading;
    and the restored model's logits equal JAX's of the params it saved."""
    jparams = _jparams()
    params = _params(jparams=jparams)
    path = ckpt.save_checkpoint(tmp_path / "ck", CFG, params)
    tokens = np.random.default_rng(1).integers(1, CFG.vocab_size, (2, 8))
    _, restored = load_or_init("llama3-test", path, dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(
        tllama.forward_train(restored, CFG, torch.as_tensor(tokens)).numpy(),
        np.asarray(jllama.forward_train(jparams, jllama.CONFIGS["llama3-test"],
                                        jnp.asarray(tokens))), **LOGIT_TOL)

    async def greedy(client):
        try:
            return (await client.chat("", "status of checkout?")).content
        finally:
            await client.shutdown()

    ref = TorchCudaClient.for_testing(params=params, device="cpu", max_new_tokens=8)
    want = asyncio.run(greedy(ref))
    for tp in (1, 2):
        client = TorchCudaClient.build("llama3-test", model_path=str(path), device="cpu",
                                       dtype=torch.float32, tp=tp, max_new_tokens=8,
                                       engine_cfg=ref.core.ecfg)
        assert client.core.cfg == CFG
        assert asyncio.run(greedy(client)) == want, tp


def test_cli_weights_convert_and_info(tmp_path, capsys):
    """``weights convert`` refuses a missing path unless ``--random-init``,
    then writes a checkpoint that ``weights info`` describes, each printing
    what the JAX CLI prints."""
    out = {}
    for pkg, main, extra in (("jax", j_main.main, []), ("port", t_main.main, ["--device", "cpu"])):
        dest = tmp_path / pkg
        assert main(["weights", "convert", str(tmp_path / "missing"), str(dest), "--int8",
                     *extra]) == 1
        assert not ckpt.is_checkpoint(dest) and not jckpt.is_checkpoint(dest)
        err = capsys.readouterr()
        assert main(["weights", "convert", str(tmp_path / "missing"), str(dest), "--int8",
                     "--random-init", *extra]) == 0
        assert main(["weights", "info", str(dest)]) == 0
        assert main(["weights", "info", str(tmp_path / "missing")]) == 1
        out[pkg] = (err.out, err.err.replace(str(dest), "<out>"),
                    capsys.readouterr().out.replace(str(dest), "<out>"))
    assert out["port"] == out["jax"]
    assert "wrote checkpoint: <out> (int8=True)" in out["port"][2]
    cfg, params = ckpt.load_checkpoint(tmp_path / "port", device="cpu")
    assert cfg == CFG and is_quantized(params["layers"]["w_down"])


def test_convert_missing_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.convert_hf_to_checkpoint(tmp_path / "nope", tmp_path / "out", device="cpu")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_convert_hf_dir_equals_the_loader(int8, tmp_path):
    """An HF directory converted (bf16 by default, or int8) restores to what
    the HF loader gives for it, under the JAX package's name rule."""
    src = FIXTURES / "hf-tiny-untied"
    path = ckpt.convert_hf_to_checkpoint(src, tmp_path / "ck", quantize_int8=int8, device="cpu")
    cfg, params = ckpt.load_checkpoint(path, device="cpu")
    want_cfg, want = load_params(src, dtype=torch.bfloat16, device="cpu", quantize_int8=int8)
    assert cfg == dataclasses.replace(want_cfg, name="hf-model")
    assert_trees_equal(want, params)


def test_checkpoint_roundtrip_moe_and_rope_scaling(tmp_path):
    """MoE (``[L, E, in, out]`` experts and the router) and a rope-scaled
    config round-trip; the rope_scaling list turns back into a tuple."""
    jcfg = dataclasses.replace(jllama.CONFIGS["mixtral-test"], rope_scaling=(8.0, 1.0, 4.0, 8192))
    cfg = dataclasses.replace(tllama.CONFIGS["mixtral-test"], rope_scaling=(8.0, 1.0, 4.0, 8192))
    for quant in (False, True):
        params = _params(quant, _jparams(cfg=jcfg, seed=3))
        path = ckpt.save_checkpoint(tmp_path / f"moe-{quant}", cfg, params)
        restored_cfg = ckpt.checkpoint_config(path)
        assert restored_cfg == cfg
        hash(restored_cfg)
        cfg2, restored = ckpt.load_checkpoint(path, device="cpu")
        assert cfg2.n_experts == 4 and cfg2.rope_scaling == (8.0, 1.0, 4.0, 8192)
        assert restored["layers"]["router"].shape == (2, 64, 4)
        w_gate = restored["layers"]["w_gate"]
        assert (w_gate["q"] if quant else w_gate).shape == (2, 4, 64, 128)
        assert_trees_equal(params, restored)


def test_jax_orbax_checkpoint_is_refused(tmp_path):
    """A checkpoint of the JAX package raises an error that names the
    format difference, wherever the port is asked to load it."""
    path = jckpt.save_checkpoint(tmp_path / "jax", jllama.CONFIGS["llama3-test"], _jparams())
    assert ckpt.is_jax_checkpoint(path) and not ckpt.is_checkpoint(path)
    for load in (lambda: ckpt.load_checkpoint(path, device="cpu"),
                 lambda: load_or_init("llama3-test", path, device="cpu"),
                 lambda: TorchCudaClient.build("llama3-test", model_path=str(path),
                                               device="cpu", dtype=torch.float32)):
        with pytest.raises(ValueError, match="orbax"):
            load()


def test_safetensors_writer_and_reader(tmp_path):
    """``write_safetensors`` of every dtype the port writes is read back bit
    for bit by ``read_safetensors`` and by the safetensors package, and the
    reader takes the package's files."""
    rng = np.random.default_rng(0)
    tensors = {"f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
               "bf16": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32)).bfloat16(),
               "i8": torch.from_numpy(rng.integers(-127, 128, (2, 3, 4)).astype(np.int8)),
               "scalar": torch.tensor(2.5), "empty": torch.zeros((0, 3)),
               "np_f32": rng.normal(size=(6,)).astype(np.float32)}
    write_safetensors(tmp_path / "port.safetensors", tensors)
    back = read_safetensors(tmp_path / "port.safetensors")
    for name, x in tensors.items():
        x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        assert back[name].dtype == x.dtype and torch.equal(back[name], x), name
    lib = load_file(str(tmp_path / "port.safetensors"))
    assert np.array_equal(lib["i8"], tensors["i8"].numpy())
    assert np.array_equal(lib["f32"], tensors["f32"].numpy())
    save_file({"a": np.arange(6, dtype=np.float32).reshape(2, 3),
               "b": np.arange(4, dtype=np.int64)}, str(tmp_path / "lib.safetensors"))
    got = read_safetensors(tmp_path / "lib.safetensors")
    assert torch.equal(got["a"], torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert torch.equal(got["b"], torch.arange(4))
