"""The grouped lookup kernel on the card, where the CPU tests cannot reach
it (a CUDA kernel has no interpret mode).

``lookup_score_grouped`` must equal, bit for bit, the per-shard fused
lookup (``lookup_score_multi``, the indexed ``lookup_kernel``) of each
block of its table, with each term's row planned from ``hash_terms`` on
the card, at the served shapes: Q of 1, 2 and 32 queries of L = 120 terms,
1, 23 and 34 blocks of W = 32 words, each in a tile of its own allocation.
Its in-kernel hash must equal ``hash_terms`` for edge terms (zero words,
all-ones words) with n_valid of 0, 1 and L: a tile whose row r holds r in
every word makes a block's counts spell the rows the kernel read.

Every test is marked ``card`` and skips without CUDA. On the card:
``python -m pytest -q -m card tests/test_torch_kernels_card.py``. This
file imports no JAX, which the card's machine does not have.
"""
import pytest
import torch

from repro_torch.core import hashing
from repro_torch.core.query import plan_rows
from repro_torch.kernels import bitslice_score as k

pytestmark = pytest.mark.card

L, W = 120, 32
# edge terms: both words zero, both all ones, and one of each
EDGES = [(0, 0), (-1, -1), (0, -1), (-1, 0), (1, 0), (0, 1)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _ints(g, lo, hi, *shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=g,
                         dtype=torch.int64).to(torch.int32)


def _terms(g, Q: int) -> torch.Tensor:
    """Random packed terms [Q, L, 2] whose first terms are the edges."""
    terms = _ints(g, -2 ** 31, 2 ** 31, Q, L, 2)
    terms[:, :len(EDGES)] = torch.tensor(EDGES, dtype=torch.int32)
    return terms


@pytest.mark.parametrize("Q", [1, 2, 32])
@pytest.mark.parametrize("nb", [1, 23, 34])
def test_grouped_equals_the_per_shard_lookup(dev, nb, Q):
    g = torch.Generator().manual_seed(100 * nb + Q)
    tiles, offs, wids = [], [], []
    for _ in range(nb):
        R = int(_ints(g, 2_000, 6_000, 1))
        tiles.append(_ints(g, -2 ** 31, 2 ** 31, R, W).to(dev))
        off = int(_ints(g, 0, 50, 1))
        offs.append(off)
        wids.append(R - off - int(_ints(g, 0, 50, 1)))
    slots = torch.randperm(nb, generator=g).tolist()
    table = k.BlockTable(tiles, offs, wids, slots, nb)
    terms = _terms(g, Q).to(dev)
    n_valid = _ints(g, 0, L + 1, Q)
    n_valid[0] = L
    if Q > 1:
        n_valid[-1] = 0
    n_valid = n_valid.to(dev)
    out = torch.full((Q, nb, W, 32), -7, dtype=torch.int32, device=dev)
    before = k.launches["lookup_score_grouped"]
    assert k.lookup_score_grouped(table, tiles, terms, n_valid, out) is out
    assert k.launches["lookup_score_grouped"] == before + 1
    h = hashing.hash_terms(terms, 1)                        # [Q, L, 1]
    mask = (torch.arange(L, device=dev)[None, :]
            < n_valid[:, None]).to(torch.int32)[:, None, :].contiguous()
    for e in range(nb):
        rows = plan_rows(h, torch.tensor([offs[e]], device=dev),
                         torch.tensor([wids[e]], device=dev))
        want = k.lookup_score_multi(
            tiles[e], rows[:, :, 0, 0][:, None, :].contiguous(), mask)
        assert torch.equal(out[:, slots[e]], want[:, 0]), (e, slots[e])
    if Q == 1:                       # no n_valid: every term counts
        again = k.lookup_score_grouped(table, tiles, terms, None,
                                       torch.empty_like(out))
        assert torch.equal(again, out)


@pytest.mark.parametrize("n_valid", [0, 1, L])
def test_grouped_hash_equals_hash_terms(dev, n_valid):
    R, off = 1 << 20, 12_345
    width = R - off - 7
    tile = torch.arange(R, dtype=torch.int32, device=dev)[:, None].repeat(
        1, W)                                   # row r holds r in each word
    table = k.BlockTable([tile], [off], [width], [0], 1)
    g = torch.Generator().manual_seed(n_valid)
    terms = _terms(g, len(EDGES))
    for q in range(len(EDGES)):              # query q starts at edge q
        terms[q, :len(EDGES)] = terms[q, :len(EDGES)].roll(-q, 0)
    nv = torch.full((len(EDGES),), n_valid, dtype=torch.int32)
    out = torch.zeros((len(EDGES), 1, W, 32), dtype=torch.int32, device=dev)
    k.lookup_score_grouped(table, [tile], terms.to(dev), nv.to(dev), out)
    rows = hashing.as_unsigned(hashing.hash_terms(terms, 1)[..., 0]) \
        % width + off                                        # [Q, L]
    bits = (rows[:, :n_valid, None] >> torch.arange(32)) & 1
    want = bits.sum(dim=1).to(torch.int32)                   # [Q, 32]
    assert torch.equal(out[:, 0].cpu(), want[:, None, :].expand(-1, W, -1))
    if n_valid == 1:                # each query's count spells its row
        spelled = (out[:, 0, 0].cpu().long() << torch.arange(32)).sum(1)
        assert spelled.tolist() == rows[:, 0].tolist()
