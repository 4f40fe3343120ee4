"""The port's LM serving front end against the JAX package's.

``serve --arch`` decodes greedily from token 1 on a KV cache, as the
reference's LM mode does; fed the reference's own weights
(``lm_init(jax.random.key(0), cfg)``, bfloat16 as configured, carried
over bit for bit) the port's loop gives the reference's tokens.  A
flipped argmax cascades through every later step, so each sequence is
compared token by token up to its first difference, which fails unless
the reference's top-two logit margin at that step is within twice the
bfloat16 logits' tolerance (the model tests' ``2**-5 · (1 + |logit|)``):
a tie within rounding.  (On this model every token agrees.)  The
example twin and the command line are driven too, and the serving
modules are imported in a subprocess to show they leave JAX out.
"""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.configs as jcfg
from repro.launch import serve as jserve
from repro.models import transformer as jtr
import repro_torch.configs as tcfg
from repro_torch.launch import serve
from repro_torch.models import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-0.5b-smoke"
BATCH, GEN, MAX_LEN = 4, 16, 128
TOL_LOGITS = 2 ** -5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and under pytest-xdist every worker's full-width thread pool would
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    """The reference's serve loop, by hand (its decode step's logits are
    needed), and its command line's printed lines."""
    cfg = jcfg.get_config(ARCH)
    params = jtr.lm_init(jax.random.key(0), cfg)  # as its serve draws them
    step = jax.jit(lambda p, t, c, n: jtr.lm_decode_step(p, cfg, t, c, n))
    cache = jtr.init_kv_cache(cfg, BATCH, MAX_LEN)
    tok = jnp.ones((BATCH,), jnp.int32)
    n = jnp.zeros((BATCH,), jnp.int32)
    toks, logits = [], []
    for _ in range(GEN):
        tok, lg, cache = step(params, tok, cache, n)
        n = n + 1
        toks.append(np.asarray(tok))
        logits.append(np.asarray(lg))
    argv = sys.argv
    sys.argv = ["serve", "--arch", ARCH, "--batch", str(BATCH), "--gen",
                str(GEN), "--max-len", str(MAX_LEN)]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv = argv
    return dict(params=jax.tree.map(np.asarray, params),
                tokens=np.stack(toks, 1), logits=np.stack(logits, 1),
                stdout=buf.getvalue())


def _first_sequence(stdout):
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("first sequence:")]
    assert len(line) == 1, stdout
    return [int(v) for v in re.findall(r"-?\d+", line[0].split(":", 1)[1])]


def test_the_reference_cli_prints_its_loops_tokens(reference):
    """Pin that the hand-run loop is the reference's serve loop."""
    assert _first_sequence(reference["stdout"]) == \
        reference["tokens"][0].tolist()


def test_serve_lm_with_the_references_weights_gives_its_tokens(reference):
    cfg = tcfg.get_config(ARCH)
    params = convert.params_from_numpy(reference["params"], device="cpu")
    assert params["embed"]["table"].dtype == torch.bfloat16
    toks, seconds = serve.serve_lm(cfg, params, batch=BATCH, gen=GEN,
                                   max_len=MAX_LEN, device="cpu")
    assert toks.shape == (BATCH, GEN) and seconds > 0
    want, logits = reference["tokens"], reference["logits"]
    compared = 0
    for b in range(BATCH):
        for i in range(GEN):
            if toks[b, i] != want[b, i]:
                top2 = np.sort(logits[b, i])[-2:]
                tie = 2 * TOL_LOGITS * (1 + abs(top2[1]))
                assert top2[1] - top2[0] <= tie, (b, i)
                break  # a tie within rounding: the rest may cascade
            compared += 1
    assert compared >= BATCH * GEN // 2, compared


def _port_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        toks = serve.main(argv)
    return buf.getvalue(), toks


_NUMBERS = re.compile(r"[0-9.]+s \([0-9.]+ tok/s\)")


def test_serve_arch_prints_the_references_lines(reference):
    out, toks = _port_cli(["--arch", ARCH, "--batch", str(BATCH), "--gen",
                           str(GEN), "--max-len", str(MAX_LEN), "--device",
                           "cpu"])
    mine, ref = out.splitlines(), reference["stdout"].splitlines()
    assert len(mine) == len(ref) == 2
    assert _NUMBERS.sub("", mine[0]) == _NUMBERS.sub("", ref[0])
    assert _first_sequence(out) == toks[0].tolist()
    vocab = tcfg.get_config(ARCH).vocab
    assert toks.shape == (BATCH, GEN) and 0 <= toks.min() <= toks.max() < vocab


@pytest.mark.parametrize("arch", ["deepseek-v3-671b-smoke",
                                  "grok-1-314b-smoke", "chatglm3-6b-smoke"])
def test_serve_arch_serves_every_lm_family(arch):
    out, toks = _port_cli(["--arch", arch, "--batch", "2", "--gen", "5",
                           "--max-len", "8", "--device", "cpu"])
    assert out.startswith("decoded 2x5 tokens in ")
    vocab = tcfg.get_config(arch).vocab
    assert toks.shape == (2, 5) and 0 <= toks.min() <= toks.max() < vocab


def test_serve_arch_runs_on_the_gpu_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", ARCH, "--gen", "1"])


def test_example_twin_serves():
    from repro_torch.examples import serve_lm

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        toks = serve_lm.main(["--device", "cpu"])
    out = buf.getvalue()
    assert toks.shape == (8, 24)
    assert out.startswith("generated 8x24 tokens in ")
    assert out.rstrip().endswith("ok ✓")


def test_example_twin_prints_the_references_lines():
    spec = importlib.util.spec_from_file_location(
        "ref_serve_lm", os.path.join(REPO, "examples", "serve_lm.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.main()
    from repro_torch.examples import serve_lm

    mine = io.StringIO()
    with contextlib.redirect_stdout(mine):
        serve_lm.main(["--device", "cpu"])
    shape = lambda s: [re.sub(r"[0-9.]+|\[.*\]|CPU|cpu", "#", ln)  # noqa
                       for ln in s.splitlines()]
    assert shape(mine.getvalue()) == shape(buf.getvalue())


def test_serving_modules_import_no_jax():
    code = """
    import sys
    import repro_torch.models.steps, repro_torch.launch.serve
    import repro_torch.models.convert, repro_torch.examples.serve_lm
    from repro_torch.launch import serve
    toks = serve.main(["--arch", "grok-1-314b-smoke", "--batch", "2",
                       "--gen", "3", "--max-len", "4", "--device", "cpu"])
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                 or m == "ml_dtypes"
                 or m == "repro" or m.startswith("repro."))
    assert not bad, bad
    print("CLEAN", toks.shape)
    """
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "CLEAN (2, 3)" in proc.stdout
