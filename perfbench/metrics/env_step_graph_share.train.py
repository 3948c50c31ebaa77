"""env_step_graph_share.train: the share of the run's env-step calls (`lap_env.autoreset_step`) that replayed a captured CUDA graph, of all of them (replays, captures and eager calls, as the program's counter `envs/step_graph.CALLS` counts them since the process began), in %; None for a program without that counter."""


def read(run):
    try:
        from carla_ppo_tpu_torch.envs import step_graph
    except ImportError:
        return None
    calls = step_graph.CALLS
    total = calls["replays"] + calls["captures"] + calls["eager"]
    return 100.0 * calls["replays"] / total if total else None
