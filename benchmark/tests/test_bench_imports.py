"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level names: `ilswiss_tpu_torch` is the port, `ilswiss_tpu` the
JAX package), and the reference loads nothing of the port."""

import json
import subprocess
import sys

from benchmark.harness.spec import ROOT

JAX = {"jax", "jaxlib", "flax", "optax", "ilswiss_tpu"}


def _top_level_after(code: str) -> set:
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
            "import json; print(json.dumps(sorted({n.split('.')[0] for n "
            "in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_port_and_no_jax():
    names = _top_level_after(
        "import benchmark.reference.sac, benchmark.reference.planar, "
        "benchmark.reference.rigid_body; "
        "from benchmark.reference import envs; "
        "[envs.load(n, 'cpu') for n in ('hopper', 'ant')]")
    assert not names & (JAX | {"ilswiss_tpu_torch"})


def test_a_run_loads_no_jax():
    # the whole of a run but the look for a card: set-up, window,
    # comparison and every metric reader, on the CPU at a tiny size
    code = (
        "import time; from benchmark.tests.conftest import tiny_cell; "
        "from benchmark.harness import cell as c; "
        "from benchmark.harness.spec import reader; "
        "import benchmark.run, benchmark.calibrate, benchmark.harness.trace; "
        "cell = tiny_cell(); "
        "[reader(m['name']) for m in cell.end_to_end + cell.per_layer]; "
        "c.run(cell, 5, 0.2, False, 'cpu', time.time(), reader)")
    names = _top_level_after(code)
    assert "ilswiss_tpu_torch" in names
    assert not names & JAX
