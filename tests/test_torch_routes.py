"""The assignment rounds' tile height, routes and the limits they raise.

The template kernel stages the whole (k, d) centroid block in one block's
shared memory; the screened route and the row passes stage their centroids
in chunks, so only the template has a k that a width and a tile height
cap (``ops.template_max_k``), and the screened route only its 16-bit
candidate index. No round takes the template any more: it is reachable
through its ``*_template`` entries alone. The CUDA source owns each round's
route and that route's largest k (``lloyd_assign_route``); the wrapper
raises a ValueError naming them. This file checks that ``choose_block_n``
keeps the heights it gave where the template fits, gives the largest past
it, that ``template_max_k`` is the largest k the template's columns fit,
which route each formerly templated round now takes, and how the wrappers
turn the source's answer into that ValueError. On the CPU the wrappers take
the plain twins; the card tests (``test_torch_screen.py``) run the routes at
and past each old limit and hold the kernels bitwise to the template
entries.
"""
from __future__ import annotations

import pytest

from repro_torch.kernels import lloyd_assign as la
from repro_torch.kernels import ops


@pytest.mark.parametrize("n,d,k,block_n", [
    (4_000_000, 2, 50, 4096),
    (100_003, 128, 64, 4096),
    (16_384, 16, 256, 4096),
    (3000, 8, 5, 2048),
    (50, 2, 4, 128),
    (10_000, 512, 128, 128),
    (1_000_000, 128, 300, 4096),
    (1_000_000, 128, 400, 2048),
    (1_000_000, 128, 416, 128),
])
def test_block_n_where_the_template_fits_is_unchanged(n, d, k, block_n):
    """Where the gated template fits at some height (and at d = 512, where
    the fp32 rounds keep the template), the height is the largest that
    fits it, as before the chunked routes."""
    assert ops.choose_block_n(n, d, k) == block_n
    if d <= 128:
        assert ops.assign_cols(d, k, block_n, gated=True) >= 1


@pytest.mark.parametrize("d,k", [(128, 417), (128, 1024), (128, 16_384),
                                 (2, 8192), (5, 65_535), (16, 4000)])
def test_block_n_past_the_template_is_the_largest(d, k):
    """Past the gated template's staging at every height, the chunked
    routes take the largest height (pass A's staging does not depend on
    it, pass B holds one tile's labels beside one k-chunk, and the row
    passes stage per block of rows), clamped to the rows there are."""
    assert ops.assign_cols(d, k, 128, gated=True) == 0
    assert ops.choose_block_n(1_000_000, d, k) == ops.MAX_BLOCK
    assert ops.choose_block_n(300, d, k) == 256


@pytest.mark.parametrize("d,gated", [(5, False), (160, False), (3, False),
                                     (7, False), (1, True), (200, False)])
@pytest.mark.parametrize("block_n", [128, 4096])
def test_template_max_k_is_the_largest_the_columns_fit(d, gated, block_n):
    """``template_max_k`` is the largest k whose (k, d) block fits beside
    one column of sums (``assign_cols`` >= 1): one more fits none."""
    most = ops.template_max_k(d, block_n, gated)
    assert most >= 1
    assert ops.assign_cols(d, most, block_n, gated) >= 1
    assert ops.assign_cols(d, most + 1, block_n, gated) == 0


class _Source:
    """A stand-in for the CUDA source's ``lloyd_assign_route``: answers
    route ``code`` with largest k ``max_k`` and records the question."""

    def __init__(self, code: int, max_k: int):
        self.code, self.max_k, self.asked = code, max_k, []

    def function(self, lib, symbol, argtypes):
        assert (lib, symbol) == ("lloyd_assign", "lloyd_assign_route")

        def route(rnd, d, bf16, out):
            self.asked.append((rnd, d, bf16))
            out._obj.value = self.max_k
            return self.code
        return route


@pytest.mark.parametrize("name,d,gated,route", [
    ("lloyd_assign", 5, False, "row pass"),
    ("lloyd_assign_batched", 3, False, "row pass"),
    ("lloyd_assign_tiled_batched", 7, False, "row pass"),
    ("lloyd_assign_gated_batched", 1, True, "split"),
    ("lloyd_assign_tiled", 200, False, "row pass"),
    ("lloyd_assign", 160, False, "row pass")])
@pytest.mark.parametrize("block_n", [128, 4096])
def test_template_routes_raise_with_their_limit(monkeypatch, name, d, gated,
                                                route, block_n):
    """The (round, width) pairs the template served, and raised past its
    staging for, now take a chunked route (the row pass, or for the gated
    batched round the split row pass), which the source answers with no
    k limit: the wrapper passes no template columns and takes k past
    ``template_max_k`` (and at 65,535) without a raise. The template
    entries keep the old limit."""
    src = _Source(la._ROUTES.index(route), 0x7fffffff)
    monkeypatch.setattr(la, "_build", src)
    old = ops.template_max_k(d, block_n, gated)
    for k in (old, old + 1, 65_535):
        assert la._route(name, d, k, block_n, False, 0,
                         gated=gated) == (route, 0)
    assert src.asked == [(la._ROUNDS[name], d, 0)] * 3
    with pytest.raises(ValueError,
                       match=rf"{name} at d={d}.*template route.*"
                             rf"k <= {old}; got k={old + 1}"):
        la._route(name, d, old + 1, block_n, False, 0, template=True,
                  gated=gated)
    assert la._route(name, d, old, block_n, False, 0, template=True,
                     gated=gated) == ("template",
                                      ops.assign_cols(d, old, block_n, gated))


@pytest.mark.parametrize("code,route", [(1, "screened"), (2, "row pass"),
                                        (3, "split")])
def test_chunked_routes_raise_only_past_the_sources_limit(monkeypatch, code,
                                                          route):
    """The chunked routes take every k up to the largest the source gives
    (the screened route's 65,535: its 16-bit candidate index), with no
    template columns, and raise one past it; a template entry never asks."""
    monkeypatch.setattr(la, "_build", _Source(code, 65_535))
    assert la._route("lloyd_assign_gated", 128, 65_535, 4096, True,
                     0) == (route, 0)
    with pytest.raises(ValueError, match=rf"{route} route.*k <= 65535; "
                                         rf"got k=65536"):
        la._route("lloyd_assign_gated", 128, 65_536, 4096, True, 0)
    src = _Source(code, 65_535)
    monkeypatch.setattr(la, "_build", src)
    assert la._route("lloyd_assign_gated", 128, 300, 4096, False, 0,
                     template=True, gated=True)[0] == "template"
    assert src.asked == []
    with pytest.raises(ValueError, match="k_chunk must be >= 0"):
        la._route("lloyd_assign_tiled", 128, 8, 4096, False, -1)
