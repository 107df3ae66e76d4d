"""The port's public surface beside the JAX package's: the names the port
adds to close it, each held to its JAX counterpart.

``native.parse_alist_native`` equal to the Python parser and to the JAX
binding on binary (padded and unpadded) and GF(q) alists, ``available()``
true where a compiler exists and false, without raising, where none does;
``codes.code_from_dense`` tables equal to JAX's; the five stream names the
harness re-exports; ``apply_normalization`` / ``apply_offset`` equal to
JAX's on f32 and f16 messages; the ``compare_decoders_torch`` example's
rows equal to ``simulate`` with the same arguments; the console scripts.
"""

import ast
import importlib
import importlib.util
import pathlib
import shutil
import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu import harness as jharness
from ldpcsimulation_tpu import native as jnative
from ldpcsimulation_tpu.codes import code_from_dense as jcode_from_dense
from ldpcsimulation_tpu.decoders import minsum as jminsum
from ldpcsimulation_tpu_torch import harness, native
from ldpcsimulation_tpu_torch.channel import (
    llr_from_channel,
    saturate,
    snr_to_n0,
    snr_to_sigma,
)
from ldpcsimulation_tpu_torch.codes import (
    code_from_dense,
    dumps_alist,
    load_named_qc,
    nb_regular,
    parse_alist,
    peg,
)
from ldpcsimulation_tpu_torch.codes.code import _ARRAY_FIELDS, _META_FIELDS
from ldpcsimulation_tpu_torch.decoders import (
    decode_bp_layered_qc,
    decode_bp_qc,
    decode_gdbf,
    decode_minsum_layered_qc,
    decode_minsum_qc,
)
from ldpcsimulation_tpu_torch.decoders.minsum import (
    apply_normalization,
    apply_offset,
)
from ldpcsimulation_tpu_torch.harness import StopRule, simulate, stream
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALIST_FIELDS = ("n", "m", "nlist", "mlist", "q", "nvals", "mvals")


def _padded(text):
    """The same alist with its adjacency rows padded by zeros to the
    maximum degree (the other layout the tokenizer detects)."""
    a = parse_alist(text)
    lines = text.splitlines()[:4]
    for rows, width in ((a.nlist, max(a.dv)), (a.mlist, max(a.dc))):
        lines += [" ".join(str(x + 1) for x in r) + " 0" * (width - len(r))
                  for r in rows]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("which", ["peg", "peg_padded", "gf4", "file"])
def test_parse_alist_native_equals_python_and_jax(which):
    if which == "file":
        text = (ROOT / "ldpcsimulation_tpu_torch" / "data"
                / "peg_1008_504.alist").read_text()
    elif which == "gf4":
        text = dumps_alist(nb_regular(24, 12, 3, q=4, seed=1))
    else:
        text = dumps_alist(peg(96, 48, 3, seed=2))
        if which == "peg_padded":
            text = _padded(text)
    got = native.parse_alist_native(text)
    want = parse_alist(text)
    jgot = jnative.parse_alist_native(text)
    for f in ALIST_FIELDS:
        assert getattr(got, f) == getattr(want, f) == getattr(jgot, f), f
    assert (got.q > 0) == (which == "gf4")


def test_native_available_where_a_compiler_is(monkeypatch, tmp_path):
    assert native.available() == (shutil.which("g++") is not None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler-x")
    assert native.available() is False  # no raise


@pytest.mark.parametrize("q", [0, 4])
def test_code_from_dense_tables_equal_jax(q):
    rng = np.random.default_rng(q)
    h = (rng.random((12, 24)) < 0.25).astype(np.int64)
    h[np.arange(12), np.arange(12)] = 1  # no empty row or column
    h[np.arange(12), 12 + np.arange(12)] = 1
    if q:
        h = h * rng.integers(1, q, h.shape)
    got, want = code_from_dense(h, q=q), jcode_from_dense(h, q=q)
    for f in _META_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in _ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert got.cn_vn.device.type == "cpu"


def test_harness_reexports_the_stream_names():
    names = ("StreamDecoder", "bp_qc_stream", "minsum_qc_stream",
             "minsum_stream", "simulate_stream")
    for name in names:
        assert getattr(harness, name) is getattr(stream, name), name
        assert name in harness.__all__
        assert hasattr(jharness, name), name
    from ldpcsimulation_tpu_torch.harness import simulate_stream  # noqa: F401


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.float16, jnp.float16)])
@pytest.mark.parametrize("alpha,delta", [(0.8, 0.15), (1.25, 0.3),
                                         (1.3, 0.1)])
def test_apply_normalization_and_offset_equal_jax(dtype, jdtype, alpha,
                                                  delta):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4096) * 2).astype(np.float32)
    x[:8] = [0.0, -0.0, delta, -delta, 0.1, -0.1, 0.3, 1e-3]
    x = x.astype(np.float16 if dtype == torch.float16 else np.float32)
    for port, jfn, v in ((apply_normalization, jminsum.apply_normalization,
                          alpha),
                         (apply_offset, jminsum.apply_offset, delta)):
        got = port(torch.from_numpy(x), v)
        want = np.asarray(jfn(jnp.asarray(x, jdtype), v))
        assert got.dtype == dtype and got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                      want.view(np.uint8))


def _example():
    path = ROOT / "examples" / "compare_decoders_torch.py"
    spec = importlib.util.spec_from_file_location("compare_decoders_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_compare_decoders_example_rows_equal_simulate(capsys):
    """Each of the example's five rows equals ``simulate`` with the same
    decoder, channel, frames and seed; ``main`` prints them."""
    ex = _example()
    snr, frames, batch = 3.0, 96, 32
    got = ex.rows(snr, frames, batch, "cpu")
    qc = load_named_qc("qc_1008_504")
    code = qc.to_code("cpu")
    n0, sigma = snr_to_n0(snr, code.rate), snr_to_sigma(snr, code.rate)
    cfg = ex.SM_CFG
    assert (cfg.num_iterations, cfg.theta, cfg.alpha) == (300, -0.9, 0.75)

    def sim(dec, pre=None):
        return simulate(code, dec, snr_db=snr,
                        stop=StopRule.fixed_frames(frames), batch_size=batch,
                        preprocess=pre, seed=7, device="cpu")

    def llr(y):
        return llr_from_channel(y, n0)

    want = [
        sim(lambda y, k: decode_minsum_qc(qc, y, 10, early_termination=True,
                                          storage_dtype=torch.float16)),
        sim(lambda y, k: decode_minsum_layered_qc(qc, y, 10,
                                                  early_termination=True)),
        sim(lambda x, k: decode_bp_qc(qc, x, 30, early_termination=True),
            llr),
        sim(lambda x, k: decode_bp_layered_qc(qc, x, 30,
                                              early_termination=True), llr),
        sim(lambda yq, k: decode_gdbf(code, yq, sigma, cfg, key=k, qc=qc),
            lambda y: saturate(y, 2.5)),
    ]
    assert [name for name, _ in got] == [
        "min-sum T=10 (flooding)", "min-sum T=10 (layered)",
        "BP T<=30 (flooding)", "BP T<=30 (layered)", "SM-NGDBF T<=300"]
    for (name, st), w in zip(got, want):
        assert st.total_words == w.total_words == frames, name
        assert (st.errors, st.word_errors, st.total_iterations) == (
            w.errors, w.word_errors, w.total_iterations), name
    assert ex.main(["--snr", "3.0", "--frames", "32", "--batch", "32",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6 and out[0].split()[:2] == ["decoder", "Eb/N0"]


#: the calls whose literal arguments make the example's configuration
EXAMPLE_CALLS = ("load_named_qc", "simulate", "preset", "decode_minsum_qc",
                 "decode_minsum_layered_qc", "decode_bp_qc",
                 "decode_bp_layered_qc", "decode_gdbf", "llr_from_channel",
                 "saturate", "add_argument")


def _example_config(path):
    """The example's configuration read from its source: for each call of
    ``EXAMPLE_CALLS``, its distinct argument lists as literals (module-level
    constants resolved, ``jnp.float16``/``torch.float16`` as ``"float16"``,
    any other expression as None), and the row names."""
    tree = ast.parse(path.read_text())
    consts = {t.id: node.value.value for node in tree.body
              if isinstance(node, ast.Assign)
              and isinstance(node.value, ast.Constant)
              for t in node.targets if isinstance(t, ast.Name)}

    def lit(e):
        if isinstance(e, ast.Constant):
            return e.value
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
            v = lit(e.operand)
            return None if v is None else -v
        if isinstance(e, ast.Name):
            return consts.get(e.id)
        if (isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name)
                and e.value.id in ("jnp", "torch")):
            return e.attr
        return None

    calls = {name: [] for name in EXAMPLE_CALLS}
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
            call = ([lit(a) for a in node.args],
                    {k.arg: lit(k.value) for k in node.keywords})
            if name in calls and call not in calls[name]:
                calls[name].append(call)
        elif (isinstance(node, ast.Tuple) and node.elts
              and isinstance(node.elts[0], ast.Constant)
              and isinstance(node.elts[0].value, str)
              and "T" in node.elts[0].value):
            names.append(node.elts[0].value)
    return calls, names


def test_compare_decoders_example_matches_the_jax_example():
    """The port's example runs the JAX example's configuration: the code,
    the seed and the stop, each decoder's iterations and options, the
    SM-NGDBF preset, the LLR and saturation preprocessing, the command-line
    defaults and the row names (``--device`` the only addition)."""
    want, want_names = _example_config(ROOT / "examples"
                                       / "compare_decoders.py")
    got, got_names = _example_config(ROOT / "examples"
                                     / "compare_decoders_torch.py")
    assert got_names == want_names and len(want_names) == 5
    # the port passes the device to simulate and to nothing else here
    sims = [(a, {k: v for k, v in kw.items() if k != "device"})
            for a, kw in got.pop("simulate")]
    assert sims == want.pop("simulate") and sims[0][1]["seed"] == 7
    args = got.pop("add_argument")
    assert [a for a in args if a[0] != ["--device"]] == want.pop(
        "add_argument")
    assert got == want
    assert want["preset"] == [(["SMNGDBF"], dict(
        num_iterations=300, theta=-0.9, noise_scale=0.975, lam=0.988,
        alpha=0.75, window_size=64))]
    assert want["decode_minsum_qc"][0][1] == dict(
        early_termination=True, storage_dtype="float16")


def test_console_scripts_name_the_ports_tools():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts["ldpc-sweep"] == "ldpcsimulation_tpu.tools.sweep:main"
    for name in ("ldpc-sweep", "ldpc-replay", "ldpc-redecode-stats"):
        jmod, jfn = scripts[name].split(":")
        mod, fn = scripts[name + "-torch"].split(":")
        assert mod == jmod.replace("ldpcsimulation_tpu.",
                                   "ldpcsimulation_tpu_torch.") and fn == jfn
        assert callable(getattr(importlib.import_module(mod), fn))
