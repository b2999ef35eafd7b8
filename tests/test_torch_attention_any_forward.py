"""The any-width forward's launch geometry (``attention_any_kernel`` and
``attention_any_cols_kernel`` in ``csrc/attention_any.cu``), which runs
only on the card: the wrapper's mirror of the header's formulas, written
out here once more from the header's text.

Heads of up to two column blocks (256 columns) run in one kernel at the
full width ``col_blocks(hd) * any_width(hd)``: 64 query rows a block (16
per warp; fewer only where L is shorter), Q's rows resident, K and V
through a ring of 64-key slots: the most of 4 and 3 that fit and keep as
many blocks an SM as the grid can use (as 2 slots allow, and no more than
one a block where the grid has at most 132 blocks). Wider heads run the
column-blocked kernel (one block of 128 columns of Q, K and V at a time,
up to 128 rows). Every block fits the 227 KB a Hopper block may use.
"""

from __future__ import annotations

import pytest
import torch

from pathway_tpu_torch.ops import attention_kernel as A

SMEM_LIMIT = 232_448  # dynamic shared memory a Hopper block may use
SM_SMEM, RESERVED = 233_472, 1024  # an SM's shared memory, and each block's reserve
SMS = 132  # H100 SXM
LENGTHS = (1, 16, 77, 128, 129, 600, 4096)


def _min_blocks(full: int, elem: int) -> int:
    """``any_min_blocks``: the launch bound's blocks an SM at 64 rows (f32
    at 32 columns spilled at four, 128 registers)."""
    if full == 16 or (full == 32 and elem == 2):
        return 4
    if full <= 64:
        return 3
    return 2 if full == 128 or elem == 2 else 1


def _full_bytes(full: int, rows: int, elem: int, slots: int) -> int:
    """``any_smem_bytes``: Q's rows and the ring's 64-key slots at the full
    width, rows padded by 16 bytes, 64 f32 fills a slot."""
    return (rows + 64 * slots) * (full * elem + 16) + 64 * 4 * slots


def _per_sm(full: int, rows: int, elem: int, slots: int) -> int:
    return min(_min_blocks(full, elem) * 64 // rows, SM_SMEM // (_full_bytes(full, rows, elem, slots) + RESERVED))


def _slots(full: int, rows: int, elem: int, blocks: int) -> int:
    want = min(-(-blocks // SMS), _per_sm(full, rows, elem, 2))
    for s in (4, 3):
        if _full_bytes(full, rows, elem, s) <= SMEM_LIMIT and _per_sm(full, rows, elem, s) >= want:
            return s
    return 2


def _any_geometry(B, L, H, hd, dtype, copy_bytes=16):
    geo = A.launch_geometry(B, L, H, hd, dtype, copy_bytes)
    if geo.route in A.ROUTES.values():
        pytest.skip("an aligned head: attention_short.cu")
    return geo


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("copy_bytes", [16, 2], ids=["copy16", "copy_min"])
def test_every_head_to_512_and_length_fits_and_names_a_kernel(dtype, copy_bytes):
    """hd 1..512 at L 1, 16, 77, 128, 129, 600 and 4,096 (2 texts, 3
    heads): every head that leaves the aligned kernel gets the full-width
    kernel up to 256 columns and the column-blocked kernel above, with the
    rows, ring slots and shared bytes the header's formulas give, never
    above 227 KB."""
    elem = torch.empty(0, dtype=dtype).element_size()
    for hd in range(1, 513):
        for L in LENGTHS:
            geo = A.launch_geometry(2, L, 3, hd, dtype, copy_bytes)
            assert geo.smem_bytes <= SMEM_LIMIT
            if geo.route in A.ROUTES.values():
                assert hd <= 128 and geo.copy_bytes == 16
                continue
            assert geo.route == A.ANY_ROUTES[dtype][0]
            ncb, width = A.col_blocks(hd), A.any_width(hd)
            assert (geo.col_blocks, geo.width) == (ncb, width)
            if ncb <= 2:
                full = ncb * width
                assert full in A.ANY_FORWARD_WIDTHS and hd <= full
                rows = min(64, -(-L // 16) * 16)
                slots = _slots(full, rows, elem, 2 * 3 * -(-L // rows))
                assert (geo.rows, geo.ring_slots) == (rows, slots)
                assert geo.smem_bytes == _full_bytes(full, rows, elem, slots)
                assert geo.resident == (L <= 128) and geo.blocks == (2, 3, -(-L // rows))
            else:
                rows = min(128, -(-L // 16) * 16)
                assert hd > 256 and width == 128 and geo.ring_slots == 0
                assert geo.rows == rows and geo.smem_bytes == (rows + 128) * (128 * elem + 16) + 256


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [136, 192, 256, 100, 12, 1])
def test_small_batches_keep_64_rows_and_deepen_the_ring(dtype, hd):
    """At 4 texts of 600 keys in 3 heads (60 blocks of 128 rows before) a
    block keeps 64 rows: 120 blocks, each an SM of its own, one wave. Rows
    are not cut to fill the last 12 SMs: a warp's chain of 30 tile steps is
    as long at any row count, and two blocks of 32 rows an SM stream K and
    V twice (1.23x slower in bf16 at 3 x 256, 2.20x in f32: the
    ``attention_ablation --any`` rows variants, PERF.md, PR 20). With one
    block an SM the ring takes the most slots that fit: 4 at up to 128
    columns and bf16 at 256, 2 in f32 at 256 (200,192 B)."""
    elem = torch.empty(0, dtype=dtype).element_size()
    copy = 2 if dtype == torch.bfloat16 and hd % 2 else elem if hd * elem % 16 else 8
    geo = _any_geometry(4, 600, 3, hd, dtype, copy)
    full = geo.col_blocks * geo.width
    assert geo.rows == 64 and geo.blocks == (4, 3, 10)
    want = 2 if (dtype, full) == (torch.float32, 256) else 4
    assert geo.ring_slots == want and geo.smem_bytes == _full_bytes(full, 64, elem, want) <= SMEM_LIMIT
    assert _per_sm(full, 64, elem, geo.ring_slots) >= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [257, 320, 384, 512, 1000])
def test_heads_above_256_columns_get_the_column_blocked_route(dtype, hd):
    """Above two column blocks the forward changes over to the column-blocked
    kernel: a route, column blocks of 128, no ring, rows up to 128."""
    geo = _any_geometry(2, 600, 2, hd, dtype)
    assert geo.route == A.ANY_ROUTES[dtype][0]
    assert geo.col_blocks == -(-hd // 128) >= 3 and geo.width == 128 and geo.ring_slots == 0
    assert geo.rows == 128 and geo.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_encoder_shapes_keep_two_blocks_an_sm(dtype):
    """The hd-256 and hd-12 encoders' attention (1,024 texts of 128 keys)
    fill the card many times over: 64 rows a block, two row tiles a text
    and head; bf16 at 256 columns holds two ring slots (four would leave
    one block an SM where the grid can use two), f32 two at 200,192 B, hd
    12 (bf16, 8-byte copies) four at 16,384 B."""
    geo = _any_geometry(1024, 128, 3, 256, dtype)
    assert (geo.rows, geo.ring_slots, geo.blocks) == (64, 2, (1024, 3, 2))
    assert geo.smem_bytes == (101_888 if dtype == torch.bfloat16 else 200_192)
    if dtype == torch.bfloat16:
        geo = _any_geometry(1024, 128, 32, 12, dtype, 8)
        assert (geo.rows, geo.ring_slots, geo.smem_bytes, geo.width) == (64, 4, 16_384, 16)


def test_any_ablation_variants_apply_to_the_sources():
    """Every variant of ``tools/attention_ablation.py --any`` matches the
    tree's ``csrc/`` where it says (each substitution's old text is there),
    names the dtypes it runs in, and only ``as_built`` leaves the sources
    as they are."""
    from pathway_tpu_torch.ops import _build
    from pathway_tpu_torch.tools import attention_ablation as ab

    tree = {f.name: f.read_text() for f in _build.CSRC.iterdir() if f.is_file()}
    assert ab.ANY_VARIANTS["as_built"][1] == []
    for name, (dtypes, subs) in ab.ANY_VARIANTS.items():
        assert set(dtypes) <= {"bfloat16", "float32"} and dtypes, name
        for fname, old, new in subs:
            assert old in tree[fname] and old != new, (name, fname)
        assert (name == "as_built") == (not subs)
