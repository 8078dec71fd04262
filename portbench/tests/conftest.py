"""Each test of the benchmark leaves the program's tracing off: importing
``portbench.program``, as a traced run's readers do, switches it on for
the rest of the process, which in a run is the run's own."""

import sys

import pytest


@pytest.fixture(autouse=True)
def program_tracing_off():
    yield
    program = sys.modules.pop("portbench.program", None)
    vars(sys.modules["portbench"]).pop("program", None)  # so the next import runs it again
    if program is not None and program._trace is not None:
        program._trace.disable()
        program._trace.drain()
