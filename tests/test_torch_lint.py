"""The port's dpflint: fixture-driven fire/stay-quiet proofs for each of
its seven checkers, the baseline's exact pins (the JAX package's 34 lock
pins under the port's names, zero error-taxonomy findings), the new- and
stale-pin findings, the whole package clean against its baseline, and the
CLI clean in a subprocess that imports neither torch nor jax.

Every fixture seeds one violation class into a throwaway tree (a bare
raise, a direct DPF_TPU_* read, an unlocked mutation, a kernel whose body
the g++ test cannot reach, a binding with no plain version, a second
build, a jax import, a wrapper that falls back) and asserts a file:line
finding; the clean twin stays quiet. Pure host-side AST and text work.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu_torch.ops import aes_torch
from distributed_point_functions_tpu_torch.tools import dpflint
from distributed_point_functions_tpu_torch.tools.dpflint.core import PACKAGE, load_baseline
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError

REPO_ROOT = Path(__file__).resolve().parents[1]
PKG = PACKAGE
JAX_BASELINE = REPO_ROOT / "tools" / "dpflint" / "baseline.json"


def write(root: Path, rel: str, text: str) -> None:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))


def run_checker(root: Path, checker: str, baseline=None):
    return dpflint.run(root, baseline, checkers=(checker,))


# ---------------------------------------------------------------------------
# The package at HEAD, its baseline and the CLI
# ---------------------------------------------------------------------------


def test_baseline_pins_what_stands():
    """Zero error-taxonomy findings, as the JAX package holds; the JAX
    baseline's 34 lock pins under the port's names plus the client's two
    `_next_id` sites (its caller holds the lock); the multihost launcher's
    environment reads; the two build sites."""
    base = load_baseline(dpflint.DEFAULT_BASELINE)
    assert set(base) == set(dpflint.CHECKER_NAMES)
    for name in ("error-taxonomy", "kernel-surface", "plain-parity", "port-isolation"):
        assert base[name] == {}, name
    jax_lock = {
        k.replace("distributed_point_functions_tpu/", f"{PKG}/", 1): v
        for k, v in load_baseline(JAX_BASELINE)["lock-discipline"].items()
    }
    assert len(jax_lock) == 34
    client = f"{PKG}/serving/client.py::DpfClient"
    assert base["lock-discipline"] == dict(jax_lock, **{
        f"{client}._attempt::unlocked:self._next_id": 1,
        f"{client}._connect_once::unlocked:self._next_id": 1,
    })
    assert set(base["env-discipline"]) == {
        f"{PKG}/parallel/multihost.py::initialize::environ[?]",
        f"{PKG}/parallel/multihost.py::_multi_host_markers_present._gt1::environ[?]",
    }
    assert base["build-budget"] == {
        f"{PKG}/ops/aes_cuda.py::_load_library::cpp_extension.load": 1,
        f"{PKG}/native/__init__.py::_build::g++": 1,
    }


def test_package_clean_in_a_process_that_imports_neither_torch_nor_jax():
    """The whole package lints clean against its baseline. main() asserts
    neither torch nor jax is in sys.modules; `-c` runs it with the package
    imported the way `python -m` imports it."""
    code = ("import sys; from distributed_point_functions_tpu_torch.tools.dpflint import "
            "__main__ as m; rc = m.main(); bad = [x for x in ('torch', 'jax') "
            "if x in sys.modules]; print('LOADED:', bad); sys.exit(rc)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean (7 checkers" in r.stdout and "LOADED: []" in r.stdout


def test_cli_exits_1_on_a_seeded_violation(tmp_path):
    write(tmp_path, f"{PKG}/utils/broken.py", '''
        def f():
            raise ValueError("nope")
        ''')
    r = subprocess.run(
        [sys.executable, "-m", "distributed_point_functions_tpu_torch.tools.dpflint",
         "--root", str(tmp_path), "--baseline", str(tmp_path / "missing.json"),
         "--checker", "error-taxonomy"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=60,
    )
    assert r.returncode == 1, r.stdout + r.stderr
    assert f"{PKG}/utils/broken.py:3: [error-taxonomy]" in r.stdout


def test_pack_errors_are_in_the_taxonomy():
    """The two bare raises the lint found in ops/aes_torch.py."""
    with pytest.raises(InvalidArgumentError, match="block count 33"):
        aes_torch.pack_to_planes(torch.zeros((33, 4), dtype=torch.int32))
    with pytest.raises(InvalidArgumentError, match="lane count 33"):
        aes_torch.pack_bit_mask(np.zeros(33, dtype=bool))
    with pytest.raises(ValueError):  # callers that catch ValueError keep working
        aes_torch.pack_bit_mask(np.zeros(33, dtype=bool))


# ---------------------------------------------------------------------------
# error-taxonomy
# ---------------------------------------------------------------------------


def test_taxonomy_fires_in_the_library_and_stays_quiet_elsewhere(tmp_path):
    write(tmp_path, f"{PKG}/ops/thing.py", '''
        from ..utils.errors import InvalidArgumentError

        def bad(x):
            raise RuntimeError("boom")

        def good(x):
            raise InvalidArgumentError("bad x")
        ''')
    # The port's tools, experiments and demos are not the library.
    for sub in ("tools", "experiments", "examples"):
        write(tmp_path, f"{PKG}/{sub}/cli.py", '''
            def main():
                raise ValueError("usage")
            ''')
    findings, _ = run_checker(tmp_path, "error-taxonomy")
    assert [(f.path, f.line) for f in findings] == [(f"{PKG}/ops/thing.py", 5)]
    assert "RuntimeError" in findings[0].message


# ---------------------------------------------------------------------------
# env-discipline
# ---------------------------------------------------------------------------


def test_env_fires_on_a_direct_flag_read_and_an_undocumented_flag(tmp_path):
    write(tmp_path, "README.md", "DPF_TPU_DOCUMENTED: documented.\n")
    write(tmp_path, f"{PKG}/ops/knob.py", '''
        import os

        def bad():
            return os.environ.get("DPF_TPU_DOCUMENTED")

        def undocumented():
            from ..utils.envflags import env_bool
            return env_bool("DPF_TPU_SECRET")
        ''')
    findings, _ = run_checker(tmp_path, "env-discipline")
    msgs = sorted(f.message for f in findings)
    assert len(msgs) == 2
    assert "direct os.environ read of DPF_TPU_DOCUMENTED" in msgs[0]
    assert "DPF_TPU_SECRET" in msgs[1] and "README" in msgs[1]


def test_env_quiet_through_envflags_and_pins_other_reads_exactly(tmp_path):
    write(tmp_path, "README.md", "DPF_TPU_DOCUMENTED\n")
    write(tmp_path, f"{PKG}/ops/knob.py", '''
        import os
        from ..utils.envflags import env_bool

        def good():
            return env_bool("DPF_TPU_DOCUMENTED")

        def rank():
            return os.environ["RANK"]
        ''')
    key = f"{PKG}/ops/knob.py::rank::environ[RANK]"
    findings, observed = run_checker(tmp_path, "env-discipline")
    assert len(findings) == 1 and "new occurrence" in findings[0].message
    assert observed["env-discipline"] == {key: 1}
    findings, _ = run_checker(tmp_path, "env-discipline", {"env-discipline": {key: 1}})
    assert findings == []
    # A pin the tree no longer has is stale.
    findings, _ = run_checker(tmp_path, "env-discipline",
                              {"env-discipline": {key: 1, key + "x": 1}})
    assert len(findings) == 1 and "stale baseline entry" in findings[0].message


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------

_THREADED = f"{PKG}/serving/batcher.py"


def test_lock_fires_on_an_unlocked_mutation_of_lock_owned_state(tmp_path):
    write(tmp_path, _THREADED, '''
        import threading

        class Batcher:
            def __init__(self):
                self._lock = threading.Lock()
                self._queue = []

            def put(self, x):
                with self._lock:
                    self._queue.append(x)

            def drain(self):
                self._queue.clear()
        ''')
    findings, observed = run_checker(tmp_path, "lock-discipline")
    key = f"{_THREADED}::Batcher.drain::unlocked:self._queue"
    assert observed["lock-discipline"] == {key: 1}
    assert len(findings) == 1 and findings[0].line == 14
    findings, _ = run_checker(tmp_path, "lock-discipline", {"lock-discipline": {key: 1}})
    assert findings == []


def test_lock_quiet_when_every_mutation_holds_the_lock(tmp_path):
    write(tmp_path, _THREADED, '''
        import threading

        class Batcher:
            def __init__(self):
                self._lock = threading.Lock()
                self._queue = []

            def put(self, x):
                with self._lock:
                    self._queue.append(x)

            def drain(self):
                with self._lock:
                    self._queue.clear()
        ''')
    # The same code outside the threaded modules is not scanned.
    write(tmp_path, f"{PKG}/ops/evaluator.py", '''
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._x = []

            def a(self):
                with self._lock:
                    self._x.append(1)

            def b(self):
                self._x.clear()
        ''')
    findings, observed = run_checker(tmp_path, "lock-discipline")
    assert findings == [] and observed["lock-discipline"] == {}


# ---------------------------------------------------------------------------
# kernel-surface and plain-parity: a one-kernel csrc/ tree
# ---------------------------------------------------------------------------

_CSRC = f"{PKG}/csrc"


def _kernel_tree(root: Path, *, kernel_body="  dpf::foo_item(x, n);",
                 cu_include="", bind_calls=1, harness='#include "foo_rows.cuh"',
                 on_cpu=True, counts=True, smoke_source="foo.cu") -> None:
    """A csrc/ with one kernel (foo.cu: its __global__, its launcher), its
    header body, the launcher's declaration and binding, the wrapper and
    plain version, the g++ harness and the chip check's kernels list."""
    write(root, f"{_CSRC}/foo_rows.cuh", '''
        #pragma once
        #include "lop3.cuh"
        namespace dpf {
        __device__ __forceinline__ void foo_item(unsigned* x, int n) { x[n] ^= 1u; }
        }
        ''')
    write(root, f"{_CSRC}/lop3.cuh", "#pragma once\n")
    write(root, f"{_CSRC}/foo.cu", f'''
#include <cstdint>
{cu_include}
#include "expand.h"
#include "foo_rows.cuh"
namespace {{
__global__ void __launch_bounds__(128, 2) dpf_foo_kernel(unsigned* x, int n) {{
{kernel_body}
}}
}}  // namespace
namespace dpf {{
void launch_foo(unsigned* x, int n, cudaStream_t stream) {{
  dpf_foo_kernel<<<1, 128, 0, stream>>>(x, n);
}}
}}  // namespace dpf
''')
    write(root, f"{_CSRC}/expand.h", '''
        #pragma once
        namespace dpf {
        // one launcher
        void launch_foo(unsigned* x, int n, cudaStream_t stream);
        }  // namespace dpf
        ''')
    calls = "\n".join("  dpf::launch_foo(words_of(x), 1, stream);" for _ in range(bind_calls))
    write(root, f"{_CSRC}/binding.cpp", f'''
#include <torch/extension.h>
#include "expand.h"
void foo(torch::Tensor x) {{
{calls}
}}
int64_t foo_words(int64_t n) {{ return n; }}
PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {{
  m.def("foo", &foo, "K foo");
  m.def("foo_words", &foo_words, "a query");
}}
''')
    branch = ("    if _on_cpu(x):\n        return backend_torch.foo(x)\n" if on_cpu else "")
    count = "    K.launches += 1\n" if counts else ""
    write(root, f"{PKG}/ops/aes_cuda.py",
          "from . import backend_torch\n\n\ndef library():\n    pass\n\n\n"
          "def _on_cpu(*t):\n    return True\n\n\n"
          f"def foo(x):\n{branch}    library().foo(x)\n{count}    return x\n")
    write(root, f"{PKG}/ops/backend_torch.py", "def foo(x):\n    return x\n")
    write(root, "tests/test_torch_kernels.py", f'_HARNESS = r"""\n{harness}\n"""\n')
    write(root, "chip_smoke.py", f'''
        def main():
            rows = {{}}
            kernels = [{{"name": "K foo", "source": "csrc/{smoke_source}"}}]
            return kernels
        ''')


def test_kernel_surface_quiet_on_a_kernel_the_harness_reaches(tmp_path):
    _kernel_tree(tmp_path)
    findings, _ = run_checker(tmp_path, "kernel-surface")
    assert findings == []


def test_kernel_surface_fires_on_a_body_the_harness_cannot_reach(tmp_path):
    # The kernel's work inline, with no header body...
    _kernel_tree(tmp_path, kernel_body="  x[n] ^= 1u;")
    findings, _ = run_checker(tmp_path, "kernel-surface")
    assert [(f.path, f.line) for f in findings] == [(f"{_CSRC}/foo.cu", 7)]
    assert "dpf_foo_kernel" in findings[0].message
    # ... or a header body the g++ harness does not include.
    _kernel_tree(tmp_path, harness='#include "lop3.cuh"')
    findings, _ = run_checker(tmp_path, "kernel-surface")
    assert len(findings) == 1 and "g++ build" in findings[0].message


def test_kernel_surface_fires_on_torch_headers_and_a_second_binding(tmp_path):
    _kernel_tree(tmp_path, cu_include="#include <ATen/cuda/CUDAContext.h>", bind_calls=2)
    findings, _ = run_checker(tmp_path, "kernel-surface")
    msgs = sorted(f.message for f in findings)
    assert len(msgs) == 2
    assert "#include <ATen/cuda/CUDAContext.h> outside binding.cpp" in msgs[0]
    assert "dpf::launch_foo is called 2 times" in msgs[1]


def test_plain_parity_quiet_on_a_complete_binding(tmp_path):
    _kernel_tree(tmp_path)
    findings, _ = run_checker(tmp_path, "plain-parity")
    assert findings == []  # and the query binding foo_words needs nothing


@pytest.mark.parametrize("broken, words", [
    (dict(on_cpu=False), "runs a plain version for CPU tensors"),
    (dict(counts=False), "adds nothing to a kernel's launch count"),
    (dict(smoke_source="other.cu"), "has no entry in chip_smoke.py's kernels list"),
])
def test_plain_parity_fires_on_a_missing_leg(tmp_path, broken, words):
    _kernel_tree(tmp_path, **broken)
    findings, _ = run_checker(tmp_path, "plain-parity")
    assert len(findings) == 1 and words in findings[0].message, findings


def test_plain_parity_fires_on_a_binding_with_no_wrapper(tmp_path):
    _kernel_tree(tmp_path)
    write(tmp_path, f"{PKG}/ops/aes_cuda.py", "def library():\n    pass\n")
    findings, _ = run_checker(tmp_path, "plain-parity")
    assert len(findings) == 1 and "has no wrapper" in findings[0].message


# ---------------------------------------------------------------------------
# build-budget
# ---------------------------------------------------------------------------


def test_build_budget_pins_build_sites_and_fires_on_inline_builds(tmp_path):
    write(tmp_path, f"{PKG}/ops/ext.py", '''
        import subprocess

        def build():
            from torch.utils.cpp_extension import load
            return load(name="x", sources=["x.cu"])

        def host():
            subprocess.run(["g++", "-O2", "x.cc"])
        ''')
    pins = {f"{PKG}/ops/ext.py::build::cpp_extension.load": 1,
            f"{PKG}/ops/ext.py::host::g++": 1}
    findings, observed = run_checker(tmp_path, "build-budget")
    assert observed["build-budget"] == pins
    assert len(findings) == 2 and all("new occurrence" in f.message for f in findings)
    findings, _ = run_checker(tmp_path, "build-budget", {"build-budget": pins})
    assert findings == []
    write(tmp_path, f"{PKG}/tools/jit.py", '''
        import torch
        from torch.utils import cpp_extension

        def f(fn):
            cpp_extension.load_inline(name="y", cpp_sources=[""])
            return torch.compile(fn)
        ''')
    findings, _ = run_checker(tmp_path, "build-budget", {"build-budget": pins})
    assert sorted(f.line for f in findings) == [6, 7]


# ---------------------------------------------------------------------------
# port-isolation
# ---------------------------------------------------------------------------


def test_isolation_fires_on_jax_imports_anywhere_in_the_package(tmp_path):
    write(tmp_path, f"{PKG}/core/a.py", "import numpy\nfrom . import b\n"
          "from distributed_point_functions_tpu_torch.core import c\n")
    write(tmp_path, f"{PKG}/examples/demo.py", "import jax.numpy as jnp\n")
    write(tmp_path, f"{PKG}/tools/t.py",
          "def f():\n    from distributed_point_functions_tpu.core import dpf\n")
    write(tmp_path, f"{PKG}/utils/u.py",
          "import importlib\nm = importlib.import_module('jaxlib')\n")
    findings, _ = run_checker(tmp_path, "port-isolation")
    assert sorted((f.path, f.line) for f in findings) == [
        (f"{PKG}/examples/demo.py", 1), (f"{PKG}/tools/t.py", 2), (f"{PKG}/utils/u.py", 2)]


def test_isolation_fires_on_a_wrapper_that_falls_back(tmp_path):
    write(tmp_path, f"{PKG}/ops/aes_cuda.py", '''
        from . import backend_torch
        from ..utils.errors import InternalError

        def good(x):
            try:
                return library().foo(x)
            except RuntimeError as e:
                raise InternalError(str(e)) from e

        def to_plain(x):
            try:
                return library().foo(x)
            except RuntimeError:
                return backend_torch.foo(x.cpu())

        def swallow(x):
            try:
                library().foo(x)
            except RuntimeError:
                pass
            return x
        ''')
    findings, _ = run_checker(tmp_path, "port-isolation")
    assert sorted(f.line for f in findings) == [14, 20]
    assert all("goes on without the kernel" in f.message for f in findings)
