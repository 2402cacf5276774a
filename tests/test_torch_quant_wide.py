"""K2's choice between its decode body and its large-M body (``wgmma``),
on the CPU: `body_for` is a pure function of the shape, x's type, the
payload's kind and the alignment, so the card tests' body checks and the
M = 8 decode paths are settled here; and the large-M body's ring of
shared memory, mirrored in Python, fits a block. The kernels themselves
run only on the card (``tests/test_torch_cuda.py``)."""
import pytest
import torch

from repro_torch.kernels.quant_matmul import ops as QMO
from test_torch_cuda import QMM_INT4_SHAPES, QMM_SHAPES

BF16 = torch.bfloat16


@pytest.mark.parametrize("packed", [False, True])
def test_decode_shapes_keep_the_decode_body(packed):
    """Every K2 shape of the card tests at M = 1, 8, 16 and 33 takes the
    decode body: its mma path for bf16 x, the CUDA cores for float32."""
    shapes = QMM_INT4_SHAPES if packed else QMM_SHAPES
    for _, K, N in shapes:
        for M in (1, 8, 16, 33):
            assert QMO.body_for(M, K, N, BF16, packed, True) == "mma"
            assert QMO.body_for(M, K, N, torch.float32, packed,
                                True) == "cuda-core"


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shape", [(12808, 4096, 1024), (12000, 512, 512)],
                         ids=["vision", "whisper"])
def test_cross_projections_take_the_large_m_body(shape, packed):
    """The w8 steps' cross K and V projections (M = 8 x 1601 patches and
    8 x 1500 frames) take the large-M body for bf16 x, int8 or packed,
    and the decode body for float32 x."""
    M, K, N = shape
    assert QMO.body_for(M, K, N, BF16, packed, True) == "wgmma"
    assert QMO.body_for(M, K, N, torch.float32, packed, True) == "cuda-core"


@pytest.mark.parametrize("packed", [False, True])
def test_the_threshold_is_the_first_large_m_row(packed):
    first = QMO.wgmma_min_m(packed)
    assert 33 < first <= 1024
    assert QMO.body_for(first, 1024, 3072, BF16, packed, True) == "wgmma"
    assert QMO.body_for(first - 1, 1024, 3072, BF16, packed, True) == "mma"


@pytest.mark.parametrize("packed", [False, True])
def test_what_tma_cannot_read_takes_the_decode_body(packed):
    """A base off a 16-byte boundary, x's rows (K bf16) or the payload's
    (N int8, ceil(N/2) packed) no multiple of 16 bytes, or K = 0: the
    decode body, decided by the shape and alignment, never by a failure."""
    M = 4096
    assert QMO.body_for(M, 4096, 1024, BF16, packed, False) == "mma"
    assert QMO.body_for(M, 4100, 1024, BF16, packed, True) == "mma"
    assert QMO.body_for(M, 0, 1024, BF16, packed, True) == "mma"
    # N 1000: 1000 bytes int8, 500 packed; N 1040: 1040 and 520
    assert QMO.body_for(M, 4096, 1000, BF16, packed, True) == "mma"
    assert QMO.body_for(M, 4096, 1040, BF16, packed, True) == (
        "mma" if packed else "wgmma")
    # N 1023 packed is 512 bytes a row
    assert QMO.body_for(M, 4096, 1023, BF16, packed, True) == (
        "wgmma" if packed else "mma")


@pytest.mark.parametrize("rows", QMO.WGMMA_ROWS)
@pytest.mark.parametrize("packed", [False, True])
def test_the_ring_fits_a_block(packed, rows):
    """``wide::Ring::kSmem``: 6 stages of an x tile (``rows`` rows of 128
    bytes) and a payload tile of 64 rows (128 bytes int8, 64 packed), two
    barriers a stage and 1024 bytes of alignment, within 232448 bytes,
    every tile 1024-byte aligned."""
    got = QMO.wgmma_smem_bytes(packed, rows)
    assert got == {(False, 128): 148576, (False, 160): 173152,
                   (True, 128): 124000, (True, 160): 148576}[packed, rows]
    assert got <= QMO.SMEM_PER_BLOCK
    stage = (got - 1024) // QMO.WGMMA_STAGES - 16
    assert stage % 1024 == 0 and (rows * 128) % 1024 == 0


def test_rows_a_block():
    """`wgmma_rows`: 160 rows at the vision cross projection (760 blocks in
    6 rounds of 132 against 808 in 7), 128 at whisper's (376 blocks in 3
    rounds either way) and where 128 rows make fewer rounds; ties keep
    128."""
    assert QMO.wgmma_rows(12808, 1024) == 160
    assert QMO.wgmma_rows(12000, 512) == 128
    assert QMO.wgmma_rows(1024, 3072) == 128
    assert QMO.wgmma_rows(8192, 1024) == 128
    assert QMO.wgmma_rows(16384, 4096) == 160
    assert QMO.wgmma_rows(256, 1024) == 128
