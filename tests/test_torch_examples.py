"""The port's four examples (``examples/torch_*.py``) on the CPU.

Each runs as a subprocess with ``--device cpu`` (the card is their
default).  Sections 1-4 of the quickstart and the whole SNN example print
the reference examples' lines exactly; serve_lm's six runs complete, count
no kernel launch on the CPU, and its packed runs' tokens are those its
``run`` gives again through the plain versions on the printed plans (what
the card's smoke run holds the kernels to); train_lm takes two steps with
finite losses; no example imports ``jax`` or ``repro``.
"""

from __future__ import annotations

import ast
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart.py", "torch_serve_lm.py", "torch_snn_addpack.py",
            "torch_train_lm.py")


def _run(script: str, *args: str) -> list[str]:
    # one thread a process: the test workers already fill the cores, and
    # train_lm's 108.8 M-parameter steps slow tenfold when their threads
    # contend with them
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    done = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args], env=env,
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    return done.stdout.splitlines()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_the_reference(name):
    tree = ast.parse((ROOT / "examples" / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not {"jax", "jaxlib", "repro"} & set(roots), (name, ast.dump(node))


def test_quickstart_sections_1_to_4_print_the_reference_lines():
    got = _run("torch_quickstart.py", "--device", "cpu")
    want = _run("quickstart.py")
    cut = next(i for i, line in enumerate(want) if line.startswith("5. "))
    assert got[:cut] == want[:cut]
    assert "   packed matmul == exact int matmul: True" in got[cut:]


def test_snn_example_prints_the_reference_lines():
    assert _run("torch_snn_addpack.py", "--device", "cpu") == _run("snn_addpack.py")


def test_serve_lm_int4_packed_greedy_run_completes():
    import importlib.util
    import json

    import torch

    from repro_torch.kernels import ref

    out = _run("torch_serve_lm.py", "--device", "cpu")
    heads = [ln for ln in out if ln.startswith("[serve_lm] quant=")]
    assert [h.split()[1:3] for h in heads] == [
        ["quant=native", "greedy"], ["quant=native", "sampled"], ["quant=int8", "greedy"],
        ["quant=int4_packed", "greedy"], ["quant=dsp_packed", "greedy"],
        ["quant=dsp_tuned", "greedy"]], out
    assert re.match(r"\[serve_lm\] quant=int4_packed  greedy  72 tokens in ", heads[3])
    assert ('[serve_lm]   launches int4_packed {"int4_matmul": 0, "int4_matmul_tc": 0, '
            '"packed_matmul": 0, "packed_matmul_tiled": 0, "packed_matmul_prepacked": 0, '
            '"packed_matmul_prepacked_tiled": 0}') in out
    tokens = {m[1]: json.loads(m[2]) for m in
              (re.fullmatch(r"\[serve_lm\]\s+tokens (\S+) greedy (.*)", ln) for ln in out) if m}
    plans = json.loads(next(m[1] for m in (re.fullmatch(r"\[serve_lm\]\s+plans dsp_tuned (.*)",
                                                         ln) for ln in out) if m))
    assert sorted(tokens) == ["dsp_packed", "dsp_tuned", "int4_packed", "int8", "native"]
    spec = importlib.util.spec_from_file_location("torch_serve_lm",
                                                  ROOT / "examples" / "torch_serve_lm.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    table = {p: ref.spec_from_name(n) for p, n in plans.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the subprocesses: its tiny ops crawl on contended threads
    try:
        again = ex.run("dsp_tuned", None, "cpu", use_kernel=False, plan_table=table)
    finally:
        torch.set_num_threads(threads)
    assert again == tokens["dsp_tuned"]


def test_train_lm_takes_two_steps():
    out = _run("torch_train_lm.py", "--device", "cpu", "--steps", "2", "--batch", "1",
               "--seq", "16")
    assert out[0] == "[train_lm] lm-100m: 108.8M params, quant=qat4"
    losses = [float(m) for m in re.findall(r"loss=([0-9.]+)", "\n".join(out))]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert re.fullmatch(r"\[train_lm\] loss [0-9.]+ -> [0-9.]+", out[-1])
