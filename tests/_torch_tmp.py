"""An autouse fixture for the port's test modules whose tests write large
temporary files (checkpoints, exported artifacts, results roots): a test
that passes leaves no ``tmp_path``, so that a whole run does not fill the
disk; a test that fails keeps it. A module takes it with

    from tests._torch_tmp import drop_tmp_path_if_passed  # noqa: F401
"""

import shutil

import pytest


@pytest.fixture(autouse=True)
def drop_tmp_path_if_passed(request):
    failed = request.session.testsfailed
    yield
    path = (request.node.funcargs or {}).get("tmp_path")
    if path is not None and request.session.testsfailed == failed:
        shutil.rmtree(path, ignore_errors=True)
