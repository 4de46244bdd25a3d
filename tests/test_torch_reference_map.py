"""The reference-test coverage map (``tests/_torch_reference_map.py``):
every test function of the JAX package's suite has an entry, every entry
names one, every port test it names exists, every entry without a
counterpart says why, and none is a gap left open ("none yet").  Test functions are read from the files' syntax
trees (what pytest collects from them), so nothing is imported."""

import ast
import pathlib

import pytest

from _torch_reference_map import MAP

TESTS = pathlib.Path(__file__).resolve().parent


def _test_functions(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name.startswith("test")}


def _suite(pattern: str, exclude: str | None = None) -> dict[str, set]:
    return {f"tests/{p.name}": _test_functions(p)
            for p in sorted(TESTS.glob(pattern))
            if exclude is None or not p.name.startswith(exclude)}


def test_every_reference_test_has_one_entry():
    ref = _suite("test_*.py", exclude="test_torch_")
    want = {f"{f}::{n}" for f, names in ref.items() for n in names}
    assert set(MAP) == want, (sorted(want - set(MAP)),
                              sorted(set(MAP) - want))


@pytest.mark.parametrize("side", ["port", "reason"])
def test_every_entry_names_live_tests_or_a_reason(side):
    port = _suite("test_torch_*.py")
    for ref_test, value in MAP.items():
        if isinstance(value, str):
            if side == "reason":
                assert value.startswith(("none: ", "none yet: ")) \
                    and len(value) > 12, ref_test
            continue
        if side == "port":
            assert value, ref_test
            for port_test in value:
                f, name = port_test.split("::")
                assert name in port.get(f, ()), (ref_test, port_test)


def test_no_reference_test_left_without_a_port_test():
    """Every behaviour the port has is held by a port test: no entry reads
    "none yet" (those left are only "none: ", nothing in the port to
    test)."""
    open_gaps = [ref for ref, value in MAP.items()
                 if isinstance(value, str) and value.startswith("none yet")]
    assert not open_gaps, open_gaps
