"""CUDA wrapper of the frozen VAE's conv encoder (source in ../csrc/vae_encode.cu).

- `encoder_cuda` <- no TPU kernel: models/vae.py's ConvEncoder in
  inference (the JAX package left the convolutions to XLA), added to take
  the encode off cuDNN.

`encoder_plain` is the plain PyTorch version, the F.conv2d + ReLU chain
that ConvEncoder runs in float32 (NCHW flatten). ConvEncoder.forward takes
the kernels when `takes_kernel` holds for its input (a CUDA float32 frame
batch [B, 80, 160, 1 or 3], the float32 compute dtype, the encoder's
widths, and no gradient recorded) and the plain chain otherwise: VAE
training, the pixel update and its recomputation, bfloat16 and CPU tensors
keep cuDNN or the CPU's convolutions. Within that domain nothing sends a
call back to cuDNN: ConvEncoder.forward hands the wrapper an aligned
contiguous copy of a misaligned input, and the wrapper splits a batch of
more than MAX_BATCH frames into launches of at most that many.

The wrapper checks device, dtype, shape, contiguity and alignment and
raises on anything else (a misaligned conv weight too), allocates its
outputs and scratch with torch.empty, launches on the current stream,
raises on a non-zero launch status, and adds 3 to LAUNCHES["vae_encode"]
per MAX_BATCH frames or fewer (three launches each). CALLS counts every
CUDA ConvEncoder.forward by the path it took.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import Tensor, nn

from carla_ppo_tpu_torch.utils.cuda_build import load_library

FRAME = (80, 160)
FEATURES = (32, 64, 128, 256)
IN_CHANNELS = (1, 3)
OUT_DIM = 256 * 3 * 8
MAX_BATCH = 32768  # the kernels index conv2's output with 32-bit ints
_K4S2 = ((4, 4), (2, 2), (0, 0), (1, 1), 1)  # kernel_size, stride, padding, dilation, groups

# Launch counts and the CUDA encoder calls by path (always on).
LAUNCHES = {"vae_encode": 0}
CALLS = {"kernel": 0, "module": 0}


def encoder_plain(x_nhwc: Tensor, convs: Sequence[nn.Conv2d]) -> Tensor:
    """relu(conv(x)) through the four convolutions, flattened in NCHW order."""
    x = x_nhwc.permute(0, 3, 1, 2)
    for conv in convs:
        x = torch.relu(conv(x))
    return x.flatten(1)


def takes_kernel(x_nhwc: Tensor, convs: Sequence[nn.Conv2d], dtype: torch.dtype) -> bool:
    """Whether ConvEncoder.forward runs the kernels for this call: the
    kernels' domain, which alignment and batch size do not limit."""
    return (x_nhwc.is_cuda and x_nhwc.dtype == torch.float32 and dtype == torch.float32
            and not torch.is_grad_enabled() and x_nhwc.dim() == 4
            and tuple(x_nhwc.shape[1:3]) == FRAME and x_nhwc.shape[3] in IN_CHANNELS
            and x_nhwc.shape[3] == convs[0].in_channels
            and tuple(c.out_channels for c in convs) == FEATURES)


def encoder_cuda(x_nhwc: Tensor, convs: Sequence[nn.Conv2d]) -> Tensor:
    """[B, 6144] = encoder_plain(x_nhwc, convs) on the card, x_nhwc a
    contiguous CUDA float32 [B, 80, 160, C] (C 1 or 3) and convs the four
    k4 s2 VALID nn.Conv2d of 32 / 64 / 128 / 256 channels; three launches
    for each MAX_BATCH frames or fewer."""
    if not isinstance(x_nhwc, Tensor) or x_nhwc.dtype != torch.float32:
        raise ValueError(f"x: expected a torch.float32 tensor, got {getattr(x_nhwc, 'dtype', type(x_nhwc))}")
    if x_nhwc.dim() != 4 or tuple(x_nhwc.shape[1:3]) != FRAME or x_nhwc.shape[3] not in IN_CHANNELS:
        raise ValueError(f"x: expected [B, {FRAME[0]}, {FRAME[1]}, 1 or 3], got {tuple(x_nhwc.shape)}")
    if not x_nhwc.is_contiguous() or x_nhwc.data_ptr() % 16:
        raise ValueError("x: expected a contiguous NHWC tensor starting on a 16-byte boundary")
    if x_nhwc.device.type != "cuda":
        raise ValueError(f"x: expected a CUDA tensor, got one on {x_nhwc.device}")
    if len(convs) != len(FEATURES):
        raise ValueError(f"convs: expected {len(FEATURES)} convolutions, got {len(convs)}")
    dev = x_nhwc.device
    batch, c = x_nhwc.shape[0], x_nhwc.shape[3]
    ptrs = []
    for i, (conv, f) in enumerate(zip(convs, FEATURES)):
        w, b = conv.weight, conv.bias
        if (conv.kernel_size, conv.stride, conv.padding, conv.dilation, conv.groups) != _K4S2 or b is None:
            raise ValueError(f"convs[{i}]: expected a k4 s2 VALID convolution with a bias")
        if w.shape != (f, c, 4, 4) or b.shape != (f,) or w.dtype != torch.float32 \
                or b.dtype != torch.float32 or w.device != dev or b.device != dev \
                or not (w.is_contiguous() and b.is_contiguous()) or w.data_ptr() % 16:
            raise ValueError(f"convs[{i}]: expected a contiguous float32 weight [{f}, {c}, 4, 4] "
                             f"starting on a 16-byte boundary and bias [{f}] on {dev}")
        ptrs += [w.data_ptr(), b.data_ptr()]
        c = f
    # Scratch: conv2's and conv3's outputs, NHWC with the channels in pairs
    # ([B][C / 2][H][W][2]), then conv3's and conv4's weights as [Cin * 16, Cout].
    chunk = min(batch, MAX_BATCH)
    sizes = (chunk * 18 * 38 * 64, chunk * 8 * 18 * 128, 16 * 64 * 128, 16 * 128 * 256)
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    y2, y3, w3t, w4t = (base + 4 * sum(sizes[:i]) for i in range(4))
    out = torch.empty((batch, OUT_DIM), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for start in range(0, batch, MAX_BATCH):  # row blocks of x and out stay 16-byte aligned
        n = min(MAX_BATCH, batch - start)
        status = load_library().launch_vae_encode(
            x_nhwc[start:].data_ptr(), n, x_nhwc.shape[3], *ptrs, y2, y3, w3t, w4t,
            out[start:].data_ptr(), stream,
        )
        if status != 0:
            raise RuntimeError(f"vae_encode launch failed with cudaError {status}")
        LAUNCHES["vae_encode"] += 3
    return out
