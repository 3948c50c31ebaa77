"""The frozen VAE encode's CUDA kernels (ops/vae_cuda.py, csrc/vae_encode.cu).

CPU: ConvEncoder.forward's dispatch rule (the kernels only for a CUDA float32
80x160 batch in float32 with no gradient recorded, handed an aligned
contiguous copy of a misaligned or strided view), the wrapper's refusals,
and the plain twin against the convolution loop ConvEncoder ran before the
kernels. Card (`-m gpu`, with --noconftest: this file imports no JAX): the
kernels against the twin on random weights and on the shipped seg VAE,
repeatability, launch counts, batches split over MAX_BATCH, a misaligned
weight refused, and the pixel policy's act.
"""

from __future__ import annotations

import pathlib

import pytest
import torch
from torch.nn import functional as F

from carla_ppo_tpu_torch.models.vae import ConvEncoder
from carla_ppo_tpu_torch.ops import vae_cuda

SEG_VAE = (pathlib.Path(__file__).resolve().parent.parent / "models" / "torch" / "vae_models"
           / "from_seg_seg_bce_cnn_zdim64_beta1_kl_tolerance0.0_deprop_data")


def _loop_encoder(enc: ConvEncoder, x_nhwc, dtype=torch.float32):
    """ConvEncoder.forward as it was before the kernels."""
    x = x_nhwc.permute(0, 3, 1, 2)
    for conv in enc.convs:
        if dtype == torch.float32:
            x = conv(x)
        else:
            x = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, stride=2)
            x = x + conv.bias.to(dtype)[:, None, None]
        x = torch.relu(x)
    return x.flatten(1)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as on the card, to drive the
    dispatch rule without one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_twin_equals_the_convolution_loop(dtype):
    """On the CPU the encoder's output is bit for bit what the convolution
    loop gave before the kernels, float32 (the plain twin) and bfloat16."""
    g = torch.Generator().manual_seed(5)
    enc = ConvEncoder(1, generator=g)
    for conv in enc.convs:
        torch.nn.init.uniform_(conv.bias, -0.1, 0.1, generator=g)
    x = torch.rand(2, 80, 160, 1, generator=g)
    with torch.no_grad():
        want = _loop_encoder(enc, x, dtype)
        assert torch.equal(enc(x, dtype), want)
        if dtype == torch.float32:
            assert torch.equal(vae_cuda.encoder_plain(x, enc.convs), want)


@pytest.mark.parametrize("case", ["cpu", "grad", "bfloat16"])
def test_dispatch_keeps_the_module_path(case, monkeypatch):
    """With a gradient recorded, the bfloat16 compute dtype, or CPU tensors,
    ConvEncoder runs its convolutions and CALLS["kernel"] does not move; the
    card-looking calls count as "module", CPU calls not at all."""
    monkeypatch.setattr(vae_cuda, "encoder_cuda", lambda *a: pytest.fail("kernel path taken"))
    enc = ConvEncoder(3, generator=torch.Generator().manual_seed(6))
    x = torch.rand(1, 80, 160, 3, generator=torch.Generator().manual_seed(7))
    dtype = torch.bfloat16 if case == "bfloat16" else torch.float32
    before = dict(vae_cuda.CALLS)
    arg = x if case == "cpu" else x.as_subclass(_CudaLooking)
    with torch.set_grad_enabled(case == "grad"):
        got = enc(arg, dtype)
        want = _loop_encoder(enc, x, dtype)
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    assert vae_cuda.CALLS["kernel"] == before["kernel"]
    assert vae_cuda.CALLS["module"] == before["module"] + (case != "cpu")


def test_dispatch_takes_the_kernels_in_inference(monkeypatch):
    """A card float32 frame batch under no_grad at the encoder's widths goes
    to the kernels (contiguous), once, counted as "kernel"."""
    seen = []
    monkeypatch.setattr(vae_cuda, "encoder_cuda", lambda x, convs: seen.append(x) or "kernels")
    enc = ConvEncoder(1)
    x = torch.rand(2, 80, 160, 1).as_subclass(_CudaLooking)
    before = dict(vae_cuda.CALLS)
    with torch.no_grad():
        assert enc(x) == "kernels"
    assert vae_cuda.CALLS == {"kernel": before["kernel"] + 1, "module": before["module"]}
    assert len(seen) == 1 and seen[0].is_contiguous()


@pytest.mark.parametrize("view", ["off a 16-byte boundary", "channels-last"])
def test_dispatch_hands_the_kernels_an_aligned_copy(view, monkeypatch):
    """A contiguous view that starts off a 16-byte boundary, or a
    non-contiguous one, still reaches the kernels: as an aligned contiguous
    tensor of the same values, counted as "kernel"."""
    seen = []
    monkeypatch.setattr(vae_cuda, "encoder_cuda", lambda x, convs: seen.append(x) or "kernels")
    enc = ConvEncoder(1)
    if view == "channels-last":
        x = torch.rand(2, 1, 80, 160).permute(0, 2, 3, 1)
    else:
        x = torch.rand(2 * 80 * 160 + 1)[1:].view(2, 80, 160, 1)
        assert x.is_contiguous() and x.data_ptr() % 16
    before = dict(vae_cuda.CALLS)
    with torch.no_grad():
        assert enc(x.as_subclass(_CudaLooking)) == "kernels"
    assert vae_cuda.CALLS == {"kernel": before["kernel"] + 1, "module": before["module"]}
    (got,) = seen
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got.as_subclass(torch.Tensor), x)


@pytest.mark.parametrize("change, takes", [
    ("none", True),
    ("grad", False),
    ("bfloat16 compute", False),
    ("float64 frames", False),
    ("84x84 frames", False),
    ("2 channels", False),
    ("other widths", False),
    ("more than MAX_BATCH frames", True),
    ("channels-last view", True),
    ("misaligned view", True),
])
def test_takes_kernel_rule(change, takes):
    """The rule reads what the call can observe: device, dtypes, shape,
    widths, gradient recording; neither the batch size nor where the input
    starts keeps a call from the kernels."""
    c = 2 if change == "2 channels" else 1
    h, w = (84, 84) if change == "84x84 frames" else (80, 160)
    features = (16, 32, 64, 128) if change == "other widths" else vae_cuda.FEATURES
    enc = ConvEncoder(c, features)
    x = torch.rand(1, h, w, c, dtype=torch.float64 if change == "float64 frames" else torch.float32)
    if change == "channels-last view":
        x = torch.rand(1, 1, h, w).permute(0, 2, 3, 1)
    if change == "misaligned view":
        x = torch.rand(h * w * c + 1)[1:].view(1, h, w, c)
    x = x.as_subclass(_CudaLooking)
    if change == "more than MAX_BATCH frames":
        x = x.expand(vae_cuda.MAX_BATCH + 1, h, w, c)
    dtype = torch.bfloat16 if change == "bfloat16 compute" else torch.float32
    with torch.set_grad_enabled(change == "grad"):
        assert vae_cuda.takes_kernel(x, enc.convs, dtype) is takes


@pytest.mark.parametrize("bad", ["cpu", "float64", "shape", "non-contiguous"])
def test_wrapper_refuses(bad):
    """The wrapper raises, launching nothing, on what the kernels do not take."""
    enc = ConvEncoder(1)
    x = {"cpu": lambda: torch.rand(2, 80, 160, 1),
         "float64": lambda: torch.rand(2, 80, 160, 1, dtype=torch.float64),
         "shape": lambda: torch.rand(2, 84, 84, 1),
         "non-contiguous": lambda: torch.rand(2, 160, 80, 1).transpose(1, 2)}[bad]()
    launches = dict(vae_cuda.LAUNCHES)
    match = {"cpu": "CUDA", "float64": "float32", "shape": r"\[B, 80, 160", "non-contiguous": "contiguous"}[bad]
    with pytest.raises(ValueError, match=match):
        vae_cuda.encoder_cuda(x, enc.convs)
    assert vae_cuda.LAUNCHES == launches


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _seeded_encoder(cin, device, seed=11):
    g = torch.Generator().manual_seed(seed)
    enc = ConvEncoder(cin, generator=g)
    for conv in enc.convs:
        torch.nn.init.uniform_(conv.bias, -0.1, 0.1, generator=g)
    return enc.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("cin", [1, 3])
@pytest.mark.parametrize("batch", [1, 3, 1024])
def test_kernels_match_twin_on_card(cuda_device, cin, batch):
    """The kernels against the plain twin (cuDNN in float32, TF32 off) on
    random weights: within 1e-5 of the largest output (the kernels sum in
    the order cuDNN 9.2 does and give its bits on an H100, but another
    cuDNN may choose another algorithm), two calls bit-identical, 3
    launches and one "kernel" call an encode."""
    enc = _seeded_encoder(cin, cuda_device)
    x = torch.rand(batch, 80, 160, cin, generator=torch.Generator(device=cuda_device).manual_seed(3),
                   device=cuda_device)
    with torch.no_grad():
        want = vae_cuda.encoder_plain(x, enc.convs)
        launches, calls = vae_cuda.LAUNCHES["vae_encode"], vae_cuda.CALLS["kernel"]
        got = enc(x)
        torch.cuda.synchronize()
        made = vae_cuda.LAUNCHES["vae_encode"] - launches
        again = enc(x)
    assert made == 3 and vae_cuda.CALLS["kernel"] == calls + 2
    assert got.shape == want.shape == (batch, vae_cuda.OUT_DIM)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_batches_over_max_batch_run_in_chunks_on_card(cuda_device, monkeypatch):
    """With MAX_BATCH cut to 2, five frames (and a misaligned view of them)
    run as three chunks of launches into one output, against the twin."""
    monkeypatch.setattr(vae_cuda, "MAX_BATCH", 2)
    enc = _seeded_encoder(1, cuda_device)
    flat = torch.rand(5 * 80 * 160 + 1, generator=torch.Generator(device=cuda_device).manual_seed(6),
                      device=cuda_device)
    x = flat[1:].view(5, 80, 160, 1)
    with torch.no_grad():
        want = vae_cuda.encoder_plain(x, enc.convs)
        launches = vae_cuda.LAUNCHES["vae_encode"]
        got = enc(x)
    assert vae_cuda.LAUNCHES["vae_encode"] == launches + 9
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_misaligned_weight_raises_on_card(cuda_device):
    """A conv weight off a 16-byte boundary raises in the wrapper; it is
    not sent back to cuDNN."""
    enc = _seeded_encoder(1, cuda_device)
    conv = enc.convs[1]
    buf = torch.empty(conv.weight.numel() + 1, device=cuda_device)
    buf[1:].copy_(conv.weight.detach().flatten())
    conv.weight = torch.nn.Parameter(buf[1:].view_as(conv.weight))
    x = torch.rand(2, 80, 160, 1, device=cuda_device)
    with torch.no_grad(), pytest.raises(ValueError, match="16-byte"):
        enc(x)


@pytest.mark.gpu
def test_shipped_seg_vae_encode_on_card(cuda_device):
    """The converted de-prop seg VAE at B = 1024: VAE.encode (the kernels and
    the mean head) against the twin and the head, max |dz| <= 1e-5 max |z|."""
    from carla_ppo_tpu_torch.models import vae_common

    vae = vae_common.load_vae(str(SEG_VAE), device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = (torch.rand(1024, 80, 160, 1, generator=g, device=cuda_device) < 0.3).float()
    with torch.no_grad():
        want = vae.mean_head(vae_cuda.encoder_plain(x, vae.encoder.convs))
        calls = vae_cuda.CALLS["kernel"]
        got = vae.encode(x)
    assert vae_cuda.CALLS["kernel"] == calls + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_pixel_act_matches_module_path_on_card(cuda_device, monkeypatch):
    """PixelActorCritic.act under no_grad through the kernels against the
    same call with the dispatch forced onto the module path: greedy actions,
    log-probs and values within 1e-5 of the largest."""
    from carla_ppo_tpu_torch.models.pixel_policy import PixelActorCritic

    model = PixelActorCritic(generator=torch.Generator().manual_seed(12)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    frames = torch.rand(64, 80, 160, 1, generator=g, device=cuda_device)
    meas = torch.rand(64, 3, generator=g, device=cuda_device)
    with torch.no_grad():
        calls = vae_cuda.CALLS["kernel"]
        act, logp, value = model.act(frames, meas, greedy=True)
        assert vae_cuda.CALLS["kernel"] == calls + 1
        monkeypatch.setattr(vae_cuda, "takes_kernel", lambda *a: False)
        act_m, logp_m, value_m = model.act(frames, meas, greedy=True)
    for a, b in ((act, act_m), (logp, logp_m), (value, value_m)):
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))
