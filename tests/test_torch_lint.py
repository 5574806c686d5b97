"""The port's lint (``bee_code_interpreter_tpu_torch/analysis/torchlint.py``):
every module of the port package must carry zero unexplained violations,
every suppression still matching a finding (a stale one fails) and saying
why, as tests/test_jaxlint.py holds the JAX package.

The second half is every case of tests/test_jaxlint.py in torch's
spelling: ``jax.jit`` -> ``torch.compile``, a jitted program's result ->
a compiled program's or a torch producer's, ``block_until_ready`` ->
``torch.cuda.synchronize``, donation -> an in-place update returning the
argument, ``static_argnums`` -> a Python-scalar annotation, ``lax``
collectives over axis names -> the port's mesh helpers
(``axis_size``/``axis_index``) and ``make_mesh``'s axes. Axis literals in
those cases lie outside the port's mesh axes (``dp``, ``fsdp``, ``tp``,
``sp``, ``ep``, ``pp``), which every file may name."""

from pathlib import Path

from bee_code_interpreter_tpu_torch.analysis import torchlint
from bee_code_interpreter_tpu_torch.analysis.torchlint import (
    PACKAGE_ROOT,
    SUPPRESSIONS,
    lint_torch_paths,
    lint_torch_source,
    port_files,
)


def _rules(source: str) -> list[str]:
    return [v.rule for v in lint_torch_source(source)]


# ------------------------------------------------------------- the repo


def test_port_has_zero_unexplained_violations():
    report = lint_torch_paths()
    assert report.files_scanned >= 45  # the whole package resolved
    assert not report.violations, "\n" + report.summary()


def test_no_stale_suppressions():
    report = lint_torch_paths()
    assert not report.stale_suppressions, (
        "suppressions no longer matching any violation — delete them:\n"
        + report.summary()
    )
    used = {s for _, s in report.suppressed}
    assert used == set(SUPPRESSIONS)


def test_every_suppression_is_justified():
    for s in SUPPRESSIONS:
        assert len(s.reason.split()) >= 8, (
            f"{s.path} [{s.rule}]: a suppression needs a real justification"
        )


def test_scope_is_the_whole_port_package():
    """Every module of the port is in scope, runtime/ and analysis/
    included: the scope is the package tree itself, not a list."""
    files = port_files()
    assert files == sorted(Path(PACKAGE_ROOT).rglob("*.py"))
    rel = {str(f.relative_to(PACKAGE_ROOT)) for f in files}
    assert {"runtime/cuda_reroute.py", "models/serving.py",
            "ops/flash_attention.py", "analysis/torchlint.py"} <= rel
    assert PACKAGE_ROOT.name == "bee_code_interpreter_tpu_torch"


def test_fresh_module_under_models_is_in_scope_by_default(tmp_path):
    """A new module under models/ is linted without anyone editing a scope
    list; a file beside the package, outside its tree, is not."""
    pkg_root = tmp_path / "fakepkg"
    models = pkg_root / "models"
    models.mkdir(parents=True)
    (models / "__init__.py").write_text("")
    (models / "shiny_new_model.py").write_text(
        "import torch\n"
        "def f(fns):\n"
        "    out = []\n"
        "    for fn in fns:\n"
        "        out.append(torch.compile(fn))\n"
        "    return out\n"
    )
    (tmp_path / "svc.py").write_text(
        "import torch\nfor i in range(3):\n    g = torch.compile(print)\n"
    )
    report = lint_torch_paths(pkg_root, suppressions=())
    assert [v.rule for v in report.violations] == ["compile-in-loop"]
    assert report.violations[0].path.endswith("models/shiny_new_model.py")


def test_torch_free_files_short_circuit():
    """The trigger pre-scan: a file with no torch spelling produces
    nothing."""
    assert _rules(
        """
        import numpy as np
        def f(items):
            out = []
            for it in items:
                out.append(np.asarray(it))
            return out
        """
    ) == []


# ------------------------------------------------- host-sync-in-hot-loop


def test_host_sync_on_compiled_result_in_loop_flagged():
    assert _rules(
        """
        import torch
        import numpy as np
        def _step(x):
            return x + 1
        m = torch.compile(_step)
        def decode(params):
            out = []
            for _ in range(10):
                logits = m(params)
                out.append(np.asarray(logits))
            return out
        """
    ) == ["host-sync-in-hot-loop"]


def test_item_on_device_value_in_loop_flagged():
    assert _rules(
        """
        import torch
        def f(xs):
            total = 0.0
            for x in xs:
                y = torch.sin(x)
                total += y.item()
            return total
        """
    ) == ["host-sync-in-hot-loop"]


def test_synchronize_in_loop_flagged():
    assert _rules(
        """
        import torch
        def f():
            for _ in range(3):
                torch.ones(3, device="cuda")
                torch.cuda.synchronize()
        """
    ) == ["host-sync-in-hot-loop"]


def test_step_path_sync_flagged_without_lexical_loop():
    # `step()` runs per token in every serving loop: a transfer anywhere
    # it reaches is per-token work even with no `for` in sight
    assert _rules(
        """
        import numpy as np
        import torch
        class Batcher:
            def step(self):
                return self._tick()
            def _tick(self):
                logits = torch.ones((2, 2))
                return np.asarray(logits)
        """
    ) == ["host-sync-in-hot-loop"]


def test_sync_via_program_attribute_alias_tracked():
    # self._verify = self._window aliasing: one compiled program, two
    # roles; the alias must still mark results as device values
    assert _rules(
        """
        from bee_code_interpreter_tpu_torch.utils.jitwatch import TrackedJit
        import numpy as np
        class B:
            def __init__(self, f):
                self._window = TrackedJit(f, "window")
                self._verify = self._window
            def step(self):
                t = self._verify(1)
                return np.asarray(t)
        """
    ) == ["host-sync-in-hot-loop"]


def test_cold_path_sync_is_clean():
    # a one-shot transfer outside any loop / step path is the normal way
    # results leave the device
    assert _rules(
        """
        import numpy as np
        import torch
        def admit():
            x = torch.ones(3)
            return np.asarray(x)
        """
    ) == []


def test_host_numpy_in_loop_is_clean():
    # np.asarray over plain host data in a loop is ordinary numpy code;
    # only values the dataflow tracks to a tensor count
    assert _rules(
        """
        import numpy as np
        import torch
        def f(items):
            dev = torch.ones(3)  # torch present, but not what crosses
            out = []
            for it in items:
                out.append(np.asarray(it))
            return out
        """
    ) == []


# -------------------------------------------- compile-in-loop / recompile


def test_compile_in_loop_flagged():
    assert "compile-in-loop" in _rules(
        """
        import torch
        def f(fns):
            out = []
            for fn in fns:
                out.append(torch.compile(fn))
            return out
        """
    )


def test_immediate_compile_invocation_flagged():
    assert _rules(
        """
        import torch
        def f(g, x):
            return torch.compile(g)(x)
        """
    ) == ["recompile-hazard"]


def test_compile_built_and_called_per_call_flagged():
    assert _rules(
        """
        import torch
        def f(step, x):
            g = torch.compile(step)
            return g(x)
        """
    ) == ["recompile-hazard"]


def test_compile_factory_return_is_clean():
    # the make_train_step shape: build once, hand the compiled callable to
    # the caller
    assert _rules(
        """
        import torch
        def make_step(step):
            return torch.compile(step, mode="reduce-overhead")
        """
    ) == []


def test_compile_bound_to_self_in_init_is_clean():
    # the serving-engine shape: compiled once at construction
    assert _rules(
        """
        import torch
        class B:
            def __init__(self, f):
                self._decode = torch.compile(f, dynamic=False)
        """
    ) == []


def test_nonconstant_compile_options_flagged():
    assert _rules(
        """
        import torch
        def f(g, mode):
            return torch.compile(g, mode=mode)
        """
    ) == ["recompile-hazard"]


def test_constant_compile_options_clean():
    assert _rules(
        """
        import torch
        def make(g):
            return torch.compile(g, mode="max-autotune", fullgraph=True)
        """
    ) == []


# --------------------------------------------------- state-copy-per-step


def test_state_copying_step_flagged():
    assert _rules(
        """
        import copy
        import torch
        def train_step(params, opt_state, batch):
            return copy.deepcopy(params), opt_state, 1.0
        def make():
            return torch.compile(train_step)
        """
    ) == ["state-copy-per-step"]


def test_in_place_state_step_clean():
    assert _rules(
        """
        import torch
        def train_step(params, opt_state, batch):
            params.add_(1.0)
            return params, opt_state, 1.0
        def make():
            return torch.compile(train_step)
        """
    ) == []


def test_step_without_state_out_is_clean():
    # a forward makes fresh values; only a copy of an argument counts
    assert _rules(
        """
        import torch
        def forward(params, tokens):
            return tokens.clone()
        def make():
            return torch.compile(lambda p, t: p.clone())  # no claim
        def make2():
            return torch.compile(forward)
        """
    ) == ["state-copy-per-step"]  # forward copies its `tokens` argument


def test_partial_bound_state_not_a_copy_candidate():
    # a functools.partial-bound kwarg is a constant of the compiled
    # program, not state it threads
    assert _rules(
        """
        import copy
        import functools
        import torch
        def apply(cfg, x):
            return copy.deepcopy(cfg)
        def make(cfg):
            return torch.compile(functools.partial(apply, cfg=cfg))
        """
    ) == []


# ------------------------------------------------- tensor-python-branch


def test_branch_on_tensor_argument_flagged():
    assert _rules(
        """
        import torch
        def f(x):
            if x > 0:
                return x * 2
            return -x
        g = torch.compile(f)
        """
    ) == ["tensor-python-branch"]


def test_while_on_tensor_argument_flagged():
    assert _rules(
        """
        import torch
        def f(x):
            while x > 0:
                x = x - 1
            return x + 0
        g = torch.compile(f)
        """
    ) == ["tensor-python-branch"]


def test_shape_dtype_none_and_len_tests_are_static():
    assert _rules(
        """
        import torch
        def f(x, mask):
            if x.shape[0] > 1:
                x = x + 1
            if mask is None:
                return x * 1
            if len(x) > 2 and x.dtype == torch.float32:
                return x + 1
            if x.size(0) > 3 and x.dim() == 2:
                return x - 1
            return x * 1
        g = torch.compile(f)
        """
    ) == []


def test_default_valued_flag_param_is_static():
    # a flag the caller leaves at its default is a Python value, not a
    # tensor: the return_kv / lora_bank idiom
    assert _rules(
        """
        import torch
        def f(x, return_aux=False):
            if return_aux:
                return x * 1, x.sum()
            return x * 1
        g = torch.compile(f)
        """
    ) == []


def test_scalar_annotation_sanctions_the_branch():
    # torch.compile specializes Python scalars: an int argument is static
    assert _rules(
        """
        import torch
        def f(n: int, x):
            if n > 4:
                return x * 2
            return x * 1
        g = torch.compile(f)
        """
    ) == []


def test_uncompiled_function_branches_freely():
    assert _rules(
        """
        import torch
        def host_helper(x):
            if x > 0:
                return torch.ones(3)
            return torch.zeros(3)
        """
    ) == []


# -------------------------------------------- collective-group-mismatch


def test_unbound_literal_axis_flagged():
    assert _rules(
        """
        from bee_code_interpreter_tpu_torch.parallel.mesh import axis_index
        def f(mesh):
            return axis_index(mesh, "model")
        """
    ) == ["collective-group-mismatch"]


def test_axis_bound_by_make_mesh_clean():
    assert _rules(
        """
        from bee_code_interpreter_tpu_torch.parallel.mesh import (
            axis_index, make_mesh)
        def f(mesh):
            return axis_index(mesh, "model")
        def wrap():
            return f(make_mesh({"model": 2}, device_type="cpu"))
        """
    ) == []


def test_axis_from_parameter_chain_clean():
    # the ring's idiom: the axis arrives as a parameter with a default
    assert _rules(
        """
        from bee_code_interpreter_tpu_torch.parallel.mesh import axis_size
        def ring(x, mesh, axis="seq"):
            n = axis_size(mesh, axis)
            return mesh.get_group(axis), n
        """
    ) == []


def test_axis_from_enclosing_closure_param_clean():
    # a nested function closes over the outer function's axis parameter
    assert _rules(
        """
        from bee_code_interpreter_tpu_torch.parallel.mesh import axis_index
        def pipelined(mesh, axis="stage"):
            def per_rank(h):
                return h + axis_index(mesh, axis)
            return per_rank
        """
    ) == []


def test_unauditable_axis_name_flagged():
    assert _rules(
        """
        from bee_code_interpreter_tpu_torch.parallel.mesh import axis_size
        AXIS = object()
        def f(mesh):
            return axis_size(mesh, AXIS)
        """
    ) == ["collective-group-mismatch"]


def test_kwarg_axis_name_checked_too():
    assert _rules(
        """
        from bee_code_interpreter_tpu_torch.parallel.mesh import axis_size
        def f(mesh):
            return axis_size(mesh, axis="seq")
        """
    ) == ["collective-group-mismatch"]


# ------------------------------------------- code-review regressions


def test_closure_factory_is_clean():
    # build once, return a closure that calls it: the nested call must not
    # read as "rebuilt per invocation"
    assert _rules(
        """
        import torch
        def make_step(f):
            g = torch.compile(f)
            def step(x):
                return g(x)
            return step
        """
    ) == []


def test_nested_def_tensor_bindings_do_not_leak_out():
    # a nested def's `logits = torch.zeros(...)` is ITS scope's name; the
    # enclosing function's same-named host list must not inherit it
    assert _rules(
        """
        import numpy as np
        import torch
        def outer(rows):
            def inner():
                logits = torch.zeros(3)
                return logits
            logits = [1.0, 2.0]
            out = []
            for r in rows:
                out.append(np.asarray(logits))
            return out, inner
        """
    ) == []


def test_lambda_body_sync_in_loop_flagged():
    # a sort key runs per comparison inside the loop: a device -> host
    # float() there is exactly the per-iteration sync the rule targets
    assert _rules(
        """
        import torch
        def f(rows):
            logits = torch.zeros((3, 3))
            for r in rows:
                rows = sorted(rows, key=lambda i: float(logits[i].sum()))
            return rows
        """
    ) == ["host-sync-in-hot-loop"]


def test_aliased_cross_file_compile_target_still_checked(tmp_path):
    # `from m import forward as fwd; torch.compile(fwd)` reaches m's
    # `forward` for the tensor-branch pass, as the unaliased import does
    pkg_root = tmp_path / "fakepkg"
    models = pkg_root / "models"
    models.mkdir(parents=True)
    (models / "__init__.py").write_text("")
    (models / "deff.py").write_text(
        "import torch\n"
        "def forward(x):\n"
        "    if x > 0:\n"
        "        return x * 2\n"
        "    return -x\n"
    )
    (models / "caller.py").write_text(
        "import torch\n"
        "from fakepkg.models.deff import forward as fwd\n"
        "g = torch.compile(fwd)\n"
    )
    report = lint_torch_paths(pkg_root, suppressions=())
    assert [v.rule for v in report.violations] == ["tensor-python-branch"]
    assert report.violations[0].path.endswith("models/deff.py")


# ----------------------------------------------- torch's own spellings


def test_cuda_graph_capture_in_loop_flagged():
    assert _rules(
        """
        import torch
        def f(fn, xs):
            for x in xs:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fn(x)
        """
    ) == ["compile-in-loop", "compile-in-loop"]


def test_branch_on_tensor_value_on_step_path_flagged():
    # no compile anywhere: on the step path an `if` on a tensor's value is
    # a hidden sync per step (and a capture breaker); shape tests are not
    assert _rules(
        """
        import torch
        class Batcher:
            def step(self):
                live = torch.ones(4) > 0
                if live.shape[0] > 2:
                    pass
                if live.any():
                    return 1
                return 0
        """
    ) == ["tensor-python-branch"]


def test_kernel_wrapper_result_is_tracked():
    # a kernel wrapper of ops/ returns a tensor on the card
    assert _rules(
        """
        from bee_code_interpreter_tpu_torch.ops.paged_attention import (
            paged_decode_attention)
        def decode(q, pools, steps):
            out = []
            for _ in range(steps):
                o = paged_decode_attention(q, *pools)
                out.append(o.tolist())
            return out
        """
    ) == ["host-sync-in-hot-loop"]


def test_step_path_clone_of_state_flagged():
    assert _rules(
        """
        import torch
        class Engine:
            def step(self, cache):
                return self._advance(cache)
            def _advance(self, cache):
                cache = cache + 1
                return cache.clone()
        """
    ) == ["state-copy-per-step"]


def test_every_rule_has_its_own_name():
    """The six rules, one for each of jaxlint's, each named in the module
    docstring."""
    rules = ("host-sync-in-hot-loop", "compile-in-loop", "recompile-hazard",
             "state-copy-per-step", "tensor-python-branch",
             "collective-group-mismatch")
    for rule in rules:
        assert f"``{rule}``" in torchlint.__doc__, rule
