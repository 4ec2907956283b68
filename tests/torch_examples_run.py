"""Run an example two ways for the example tests: the port's module
in-process through its ``main(argv)``, and the JAX package's script with
``runpy`` under the same ``sys.argv``; each returns what it printed. Also
the tests' one-thread fixture."""

from __future__ import annotations

import contextlib
import importlib
import io
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch thread for a module's tests: the test run gives each of its
    workers about one core, and torch's default of one thread a core
    oversubscribes them (examples that take seconds alone took minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_port(name: str, *argv: str) -> str:
    """``cilantro_tpu_torch.examples.<name>.main([*argv, "--device", "cpu"])``:
    its standard output (it must return 0)."""
    mod = importlib.import_module(f"cilantro_tpu_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main([*argv, "--device", "cpu"]) == 0
    return buf.getvalue()


def run_jax(name: str, *argv: str) -> str:
    """``examples/<name>.py`` run as ``__main__`` with ``sys.argv`` set:
    its standard output."""
    path = str(REPO / "examples" / f"{name}.py")
    buf, old = io.StringIO(), sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


def numbers(text: str) -> list:
    """Every number in ``text``, in order, as floats."""
    return [float(x) for x in NUMBER.findall(text)]


def line(text: str, start: str) -> str:
    """The one line of ``text`` that starts with ``start``."""
    found = [ln for ln in text.splitlines() if ln.startswith(start)]
    assert len(found) == 1, (start, text)
    return found[0]
