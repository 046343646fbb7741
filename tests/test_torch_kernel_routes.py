"""Which route of K2 (flash attention) and K3 (SSD scan) each shape and
type takes, and that nothing beyond the routes is taken: the routes are a
Python function of (shape, type) that the launcher follows, so they are
tested here on the CPU.  The kernels themselves run in
``tests/test_torch_cuda.py`` on the card."""
import pytest
import torch

from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import ssd_scan as K3

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("d", K2.HEAD_DIMS)
def test_k2_fast_head_dims_take_the_fast_route_of_their_type(d):
    assert K2.route(d, BF16) == "wgmma"
    assert K2.route(d, F32) == "fma"


@pytest.mark.parametrize("d", [1, 8, 12, 16, 20, 32, 96, 192, 255])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k2_other_head_dims_take_the_generic_route(d, dtype):
    assert K2.route(d, dtype) == "generic"


@pytest.mark.parametrize("dtype,path", [(BF16, "wgmma"), (F32, "fma")])
def test_k2_head_dim_256_takes_the_fast_route_of_its_type(dtype, path):
    """paligemma-3b's head dim: bf16 on the tensor cores, not the generic
    route."""
    assert K2.route(256, dtype) == path


@pytest.mark.parametrize("d", [0, -1, 257, 512])
def test_k2_head_dims_beyond_every_route_raise(d):
    with pytest.raises(ValueError, match="head dim"):
        K2.route(d, BF16)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_k2_other_types_raise(dtype):
    with pytest.raises(TypeError):
        K2.route(64, dtype)


def test_k2_build_lists_the_fast_head_dims():
    """64, 128, 160 and 256 as bits 1, 3, 4 and 7 of the mask (bit D / 32 -
    1)."""
    assert K2.HEAD_DIMS == (64, 128, 160, 256)
    assert K2.NVCC_FLAGS == ("-DFLASH_FAST_D32_MASK=0x9au",)
    assert set(K2.ROUTES) == {"fma", "wgmma", "generic"}


@pytest.mark.parametrize("n", K3.STATE_DIMS)
@pytest.mark.parametrize("p", K3.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k3_listed_dims_take_the_chunked_route(n, p, dtype):
    assert K3.route(n, p, dtype) == "chunked"


@pytest.mark.parametrize("n,p", [(16, 16), (16, 64), (64, 16), (1, 1),
                                 (32, 96), (256, 128), (128, 256)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k3_other_dims_take_the_generic_route(n, p, dtype):
    assert K3.route(n, p, dtype) == "generic"
    assert K3.scratch_bytes(1, 300, 4, n, p, dtype) == 0


@pytest.mark.parametrize("n,p", [(0, 16), (16, 0), (256, 256), (1024, 64)])
def test_k3_dims_beyond_every_route_raise(n, p):
    with pytest.raises(ValueError, match="N, P"):
        K3.route(n, p, F32)


def test_k3_generic_route_fits_a_block_of_shared_memory():
    """The largest generic state is the H100's 227 KB a block can use."""
    assert K3.generic_smem_bytes(224, 256) <= K3.MAX_BLOCK_SMEM
    assert K3.route(224, 256, F32) == "generic"
    assert K3.generic_smem_bytes(256, 256) > K3.MAX_BLOCK_SMEM


def test_k3_other_types_raise():
    with pytest.raises(TypeError):
        K3.route(16, 16, torch.float16)


def test_k3_build_lists_the_chunked_dims():
    """64 and 128 as bits 0 and 1 of each mask (bit d / 64 - 1)."""
    assert K3.NVCC_FLAGS == ("-DSSD_FAST_N_MASK=0x3u",
                             "-DSSD_FAST_P_MASK=0x3u")
    assert K3.ROUTES == ("chunked", "generic")


def test_cpu_tensors_take_the_plain_versions_at_any_shape():
    """On the CPU the wrappers run the plain versions, whatever the route
    would be on the card, and count no launch."""
    K2.reset_counts()
    K3.reset_counts()
    q = torch.randn(1, 5, 2, 300)
    assert K2.flash_attention(q, q, q).shape == q.shape
    x = torch.randn(1, 5, 2, 8)
    dt = torch.ones(1, 5, 2)
    B = torch.randn(1, 5, 1, 300)
    y, state = K3.ssd_scan(x, dt, -torch.ones(2), B, B)
    assert y.shape == x.shape and state.shape == (1, 2, 300, 8)
    assert (K2.LAUNCHES, K3.LAUNCHES) == (0, 0)
    assert not any(K2.ROUTE_LAUNCHES.values())
    assert not any(K3.ROUTE_LAUNCHES.values())


@pytest.mark.parametrize("n,p", [(64, 64), (128, 64), (16, 16), (256, 32)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k3_backward_takes_the_forwards_route(n, p, dtype):
    assert K3.backward_route(n, p, dtype) == K3.route(n, p, dtype)


def test_k3_backward_generic_route_fits_state_and_cotangent():
    """The generic backward keeps the state and its cotangent in shared
    memory: it refuses an N, P the forward's generic route still takes."""
    n = p = 200
    assert K3.route(n, p, F32) == "generic"
    assert K3.generic_bwd_smem_bytes(n, p) > K3.MAX_BLOCK_SMEM
    with pytest.raises(ValueError, match="cotangent"):
        K3.backward_route(n, p, F32)
    assert K3.generic_bwd_smem_bytes(96, 96) <= K3.MAX_BLOCK_SMEM
    assert K3.backward_route(96, 96, BF16) == "generic"


def test_k3_backward_beyond_every_route_raises():
    with pytest.raises(ValueError, match="N, P"):
        K3.backward_route(1024, 64, F32)
    with pytest.raises(TypeError):
        K3.backward_route(64, 64, torch.float16)
