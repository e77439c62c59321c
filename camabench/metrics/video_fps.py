"""Video frames handed to the encoders per second of the window, every
scene's and source's, through cama_tpu_torch.cli.main (main.py --config),
encoding and the scenes' preparation included."""
UNIT, SOURCE = "frames/s", "host_clock"


def read(r):
    return r.frames / r.window_s if r.produces == "video_frames" else None
