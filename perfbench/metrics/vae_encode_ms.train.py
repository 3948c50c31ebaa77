"""vae_encode_ms.train: ms of one frozen-VAE encode of the rollout (VAE.encode of a 1024-frame batch) between CUDA events, mean over the window."""


def read(run):
    return run.span_mean_ms("vae_encode")
