"""The wire leg of the reference's tests/test_multimap_pes_json_semantics.py, unedited, on the
port's server and client (tests/_torch_port_suite.py): ``client`` is the
port's RemoteRedisson; only the tests that take ``client`` or
``remote_client`` are collected (the embedded leg runs in
tests/test_torch_collection_suites.py).  ``WAITING`` names each test left
out and the slice it waits for."""
import pytest

from tests import _torch_port_suite

WAITING: dict = {}

globals().update(_torch_port_suite.load("test_multimap_pes_json_semantics", WAITING, __name__,
                                          only=("client", "remote_client")))


@pytest.fixture()
def client(remote_client):
    return remote_client
