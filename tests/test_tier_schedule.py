"""The tier marks that the two conftest files give the eight nightly cases.

Both conftest files are loaded as modules of their own and their
collection hooks are called, in pytest's order (the inner file first), on
stand-in items, so nothing here collects or runs another test.
"""

import ast
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


inner = _load("tests_conftest", HERE / "conftest.py")
root = _load("root_conftest", HERE.parent / "conftest.py")

PLANAR = "tests/test_planar_dynamics.py"
LOCO = "tests/test_locomotion.py"

# node id -> the marks its file gives it
INTERPRET = {
    f"{PLANAR}::test_kernel_control_step_matches_engine[hopper]":
        {"nightly"},
    f"{PLANAR}::test_kernel_control_step_matches_engine[halfcheetah]":
        {"nightly"},
    f"{PLANAR}::test_env_rollout_through_kernel_stays_close": {"nightly"},
}
OTHER_NIGHTLY = {
    "tests/test_pgs_pallas.py::test_engine_step_unchanged_on_cpu": set(),
    **{f"{LOCO}::{test}[{env}-v5-{env}Device]": {"nightly"}
       for test in ("test_step_matches_gymnasium",
                    "test_reset_distribution_bounds")
       for env in ("Ant", "Humanoid")},
}


class Item:
    """What the hooks read of a pytest item: its node id and its marks."""

    def __init__(self, nodeid, marks=()):
        self.nodeid = nodeid
        self.marks = set(marks)

    def add_marker(self, mark):
        self.marks.add(mark.name)

    def get_closest_marker(self, name):
        return name if name in self.marks else None


def _marks(cases):
    items = [Item(nodeid, marks) for nodeid, marks in cases.items()]
    for conftest in (inner, root):
        conftest.pytest_collection_modifyitems(None, items)
    return {item.nodeid: item.marks for item in items}


def test_interpret_cases_are_slow_and_nightly():
    assert _marks(INTERPRET) == {n: {"slow", "nightly"} for n in INTERPRET}


def test_other_nightly_cases_stay_in_the_per_commit_gate():
    assert _marks(OTHER_NIGHTLY) == {n: {"nightly"} for n in OTHER_NIGHTLY}


def test_interpret_ids_name_tests_of_their_file():
    # a renamed test would silently drop its mark and return to tier-1
    tree = ast.parse((HERE.parent / PLANAR).read_text())
    tests = {node.name for node in tree.body
             if isinstance(node, ast.FunctionDef)}
    assert {n.split("::")[1] for n in root._INTERPRET} <= tests
