"""The reference's tests/test_migration_journal.py, unedited, on the port's
migration journals (server/migration_journal.py, resume, rearm_recovery, the import journal)
(tests/_torch_port_suite.py).  Every test runs (``WAITING`` is empty)."""
import pytest

from tests import _torch_port_suite

WAITING: dict = {}

globals().update(_torch_port_suite.load("test_migration_journal", WAITING, __name__))


@pytest.fixture(autouse=True)
def _time_limit():
    # each test here starts a cluster of servers: a limit of its own
    with _torch_port_suite.time_limit(120):
        yield
