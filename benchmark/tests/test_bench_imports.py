"""What the harness and the reference load: never JAX nor the JAX
package (compared by whole top-level names: the port's name begins with
the JAX package's), and the reference nothing of the program."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set:
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, bench=BENCH,
                                            imports=imports)],
        capture_output=True, text=True, env=env, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded("import harness, run, compare, devtrace, traffic, roofline\n"
                  "import iridium_tpu_torch.runtime.pipeline\n"
                  "import iridium_tpu_torch.output.raw\n"
                  "import metrics.idle_pct, metrics.frontend_roofline")
    assert not mods & {"jax", "jaxlib", "flax", "iridium_tpu"}
    assert "iridium_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = loaded("import reference.decode, reference.scan, synth")
    assert not mods & {"jax", "jaxlib", "flax", "iridium_tpu",
                       "iridium_tpu_torch"}


def test_forbidden_names_are_whole():
    import harness
    try:
        sys.modules["iridium_tpu_torch_x"] = sys
        assert "iridium_tpu" not in harness.forbidden_modules()
        sys.modules["iridium_tpu.sub"] = sys
        assert "iridium_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.pop("iridium_tpu_torch_x", None)
        sys.modules.pop("iridium_tpu.sub", None)
