"""``top_k`` and one served request on a query of more than 65,535 terms,
through the port, against the JAX package, on the CPU (the index and query
of ``test_torch_terms.py``). Every comparison is exact."""
import pytest
import torch

from repro.core import QueryEngine as JaxEngine
from test_torch_terms import (THRESHOLD, assert_same_result,
                              long_query_world)

from repro_torch.core import QueryEngine
from repro_torch.serve import QueryServer, ServerConfig, Status

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    return long_query_world()


@pytest.mark.parametrize("method", ["vertical", "lookup"])
def test_long_top_k_equals_reference(world, method):
    jax_index, port, long_pat, _ = world
    want = JaxEngine(jax_index, method="ref").top_k(long_pat, 5)
    got = QueryEngine(port, method=method, device="cpu").top_k(long_pat, 5)
    assert_same_result(got, want)


def test_long_served_request_equals_reference(world):
    jax_index, port, long_pat, _ = world
    want = JaxEngine(jax_index, method="ref").search(long_pat, THRESHOLD)
    server = QueryServer(port, ServerConfig(), device="cpu")
    rid = server.submit(long_pat, threshold=THRESHOLD)
    server.drain()
    resp = server.pop_responses()[rid]
    assert resp.status == Status.OK and resp.method
    assert_same_result(resp.result, want)
