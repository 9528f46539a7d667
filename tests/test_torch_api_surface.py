"""The port's public surface against the JAX package's, read by AST.

Three sweeps, one parametrised case per module:

(a) every name of ``REFERENCE_PUBLIC_FUNCTIONS`` (read out of
    tests/test_api_surface.py, which stays the JAX package's test) is
    present in the matching ``echopype_torch`` module;
(b) every public top-level def, class and assignment of every
    ``echopype_tpu`` module has a same-named counterpart in the matching
    ``echopype_torch`` module, but for the declared ports of the Pallas
    modules and of ``ek_power_cal_jit`` (:data:`PORTED_AS`);
(c) for every top-level function of the same name in both packages, the
    JAX positional parameters are a prefix of the port's (a caller passing
    the JAX arguments by position gets the same binding) and the JAX
    keyword-only parameters are among the port's parameters.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "echopype_tpu", ROOT / "echopype_torch"

#: JAX module -> (port module, {JAX name: port name}): the only names the
#: port carries under another name or in another module
PORTED_AS = {
    "ops/pallas_window.py": ("ops/window_partials.py", {
        "window_partials_pallas_uniform": "window_partials_uniform",  # K1
        "window_partials_pallas": "window_partials",  # K2
    }),
    "ops/pallas_pipeline.py": ("ops/sv_bin_partials.py", {
        "sv_bin_partials_pallas": "sv_bin_partials",  # K3
        "mvbs_partials_pallas": "mvbs_partials",  # K4
        "sv_mvbs_core_pallas": "sv_mvbs_core_fused",
        "mvbs_core_pallas": "mvbs_core_fused",
    }),
    "ops/calibration.py": ("ops/calibration.py", {"ek_power_cal_jit": "ek_power_cal_torch"}),
}


def _top_level(path):
    """{public name: AST node} of a module's top-level defs, classes and
    assignments."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            out.update({t.id: node for t in node.targets if isinstance(t, ast.Name)})
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _dotted(rel):
    parts = list(Path(rel).with_suffix("").parts)
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _port_module(rel):
    name = _dotted(rel)
    return importlib.import_module("echopype_torch" + ("." + name if name else ""))


def _reference_public_functions():
    """REFERENCE_PUBLIC_FUNCTIONS of tests/test_api_surface.py, by AST (the
    module imports the JAX package at its top)."""
    for node in ast.parse((ROOT / "tests" / "test_api_surface.py").read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "REFERENCE_PUBLIC_FUNCTIONS" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("REFERENCE_PUBLIC_FUNCTIONS not found in tests/test_api_surface.py")


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))
REFERENCE = _reference_public_functions()


def _common_functions(rel):
    """(JAX, port) function nodes of the same name in both modules."""
    port = PORT_PKG / rel
    if not port.exists():
        return []
    j, t = _top_level(JAX_PKG / rel), _top_level(port)
    fn = (ast.FunctionDef, ast.AsyncFunctionDef)
    return [(j[n], t[n]) for n in sorted(set(j) & set(t))
            if isinstance(j[n], fn) and isinstance(t[n], fn)]


SIGNATURE_MODULES = [rel for rel in JAX_MODULES if _common_functions(rel)]


@pytest.mark.parametrize("module", sorted(REFERENCE))
def test_reference_public_functions_present(module):
    """(a) the reference-named API of tests/test_api_surface.py."""
    mod = importlib.import_module("echopype_torch." + module)
    missing = [n for n in REFERENCE[module] if not hasattr(mod, n)]
    assert not missing, f"echopype_torch.{module} lacks {missing}"


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    """(b) every public top-level name of the JAX module, in the port."""
    port_rel, renamed = PORTED_AS.get(rel, (rel, {}))
    mod = _port_module(port_rel)
    names = _top_level(JAX_PKG / rel)
    assert set(renamed) <= set(names), f"stale PORTED_AS entries for {rel}"
    missing = [f"{n} (as {renamed.get(n, n)})" for n in sorted(names)
               if not hasattr(mod, renamed.get(n, n))]
    assert not missing, f"echopype_torch/{port_rel} lacks {missing}"
    # a declared port is a real rename: the JAX name itself is absent
    assert not [n for n in renamed if hasattr(mod, n)], f"PORTED_AS of {rel} is not needed"


def _positional(fn):
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


@pytest.mark.parametrize("rel", SIGNATURE_MODULES)
def test_jax_positional_parameters_are_a_prefix(rel):
    """(c) the JAX parameters bind the same way in the port."""
    bad = []
    for j, t in _common_functions(rel):
        jp, tp = _positional(j), _positional(t)
        kw_only = [a.arg for a in j.args.kwonlyargs]
        port_params = set(tp) | {a.arg for a in t.args.kwonlyargs}
        if tp[: len(jp)] != jp or not set(kw_only) <= port_params:
            bad.append(f"{j.name}: JAX {jp} kw-only {kw_only}, port {tp}")
    assert not bad, f"{rel}: {bad}"
