"""Temporary files of the port's tests that hold full-width weights.

pytest keeps every test's ``tmp_path`` after the session, and the base directories of
the last three sessions with them, so full-width checkpoints (~95 MB of weights, ~280
MB with the Adam moments) pile up across a tier-1 run and the runs before it, on a disk
they share. A test module that writes such files imports `delete_tmp_path`, which
deletes each test's ``tmp_path`` when the test ends, and module fixtures that write them
into ``tmp_path_factory`` directories delete those when the module ends.
"""
import shutil

import pytest


@pytest.fixture(autouse=True)
def delete_tmp_path(request):
    """Deletes the test's ``tmp_path`` (when it asked for one) after the test."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)
