"""The import guards: top-level names compared whole."""

import subprocess
import sys

from zbench import cells, guard


def test_top_level_names_are_compared_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "zeebe_tpu",
              "zeebe_tpu.ops", "zeebe_tpu_torch", "zeebe_tpu_torch.ops", "jaxtyping",
              "zeebe_tpux", "numpy"]
    assert guard.forbidden_loaded(loaded) == ["flax.linen", "jax", "jax.numpy",
                                              "jaxlib.xla_client", "zeebe_tpu",
                                              "zeebe_tpu.ops"]


def test_the_reference_imports_nothing_of_jax_or_the_program(tmp_path):
    assert guard.reference_violations(cells.ROOT / "zbench" / "reference") == []
    (tmp_path / "bad.py").write_text("import zeebe_tpu_torch.protocol\nfrom jax import numpy\n"
                                     "import zeebe_tpux\nfrom . import judge\n")
    assert guard.reference_violations(tmp_path) == ["bad.py: jax",
                                                    "bad.py: zeebe_tpu_torch.protocol"]


def test_the_harness_loads_no_jax_and_no_jax_package():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import zbench.run, zbench.drive, zbench.system, zbench.faults, zbench.trace,"
            " zbench.window, zbench.roofline, zbench.control;"
            "from zbench import guard; print(guard.forbidden_loaded(list(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code, str(cells.ROOT)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
