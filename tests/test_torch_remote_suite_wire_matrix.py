"""The reference's tests/test_wire_matrix.py, unedited, on the port's
server and clients (tests/_torch_port_suite.py).  ``WAITING`` names each
test left out and the slice it waits for."""
from tests import _torch_port_suite

WAITING = {
    "test_cluster_surface": "M8 (ClusterRunner)",
    "test_cluster_config_create": "M8 (ClusterRunner, the cluster client)",
    "test_dns_monitor_change_detection": "M8 (net/dns.py)",
    "test_host_of_parsing": "M8 (net/dns.py)",
    "test_create_rejects_bad_read_mode": "M8 (the cluster client's config)",
    "test_cluster_map_cache_entry_listener": "M8 (ClusterRunner)",
}

globals().update(_torch_port_suite.load("test_wire_matrix", WAITING, __name__))
