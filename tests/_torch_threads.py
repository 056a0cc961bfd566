"""A fixture for the port's tests: ``from _torch_threads import
one_torch_thread`` in a test module runs torch's CPU ops there on one
thread."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread in the importing module: the test run
    shares the host's cores among several worker processes, and a pool of
    threads per process then waits on the others at every small operation
    (in a run of six workers on eight cores, the port's twelve slowest test
    files took 2,974 s of worker time with torch's own thread pools and
    756 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
