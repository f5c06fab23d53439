"""The reference's tests/test_verb_audit_tail.py, unedited, on the port
(tests/_torch_port_suite.py).  ``WAITING`` names each test left out and the
slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_flushdb_is_flushall": "M11 (its server takes checkpoint_path; FLUSHDB)",
    "test_hmset_replies_ok": "M11 (its server takes checkpoint_path)",
    "test_zintercard": "M11 (its server takes checkpoint_path)",
    "test_bgsave_and_lastsave": "M11 (checkpoints; BGSAVE, LASTSAVE)",
    "test_bgrewriteaof_degrades_to_checkpoint": "M11 (checkpoints; BGREWRITEAOF)",
    "test_shutdown_saves_and_stops": "M11 (checkpoints; SHUTDOWN)",
    "test_ft_config_roundtrip": "M11 (its server takes checkpoint_path)",
    "test_ft_synonyms_expand_queries": "M11 (its server takes checkpoint_path)",
}

globals().update(_torch_port_suite.load("test_verb_audit_tail", WAITING, __name__))
