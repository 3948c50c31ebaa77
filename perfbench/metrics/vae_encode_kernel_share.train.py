"""vae_encode_kernel_share.train: the share of the run's CUDA ConvEncoder.forward calls that ran the hand-written encode kernels, of all CUDA calls (kernels and module path, as the program's counter `ops/vae_cuda.CALLS` counts them since the process began), in %; None for a program without that counter."""


def read(run):
    try:
        from carla_ppo_tpu_torch.ops import vae_cuda
    except ImportError:
        return None
    calls = vae_cuda.CALLS
    total = calls["kernel"] + calls["module"]
    return 100.0 * calls["kernel"] / total if total else None
