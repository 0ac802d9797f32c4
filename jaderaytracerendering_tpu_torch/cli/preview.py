"""Progressive preview CLI — the PathTrace.cpp interactive app equivalent.

Renders progressive frames of the 2-bounce preview integrator (one spp
batch per frame, accumulated into the film like the reference's lastFrame
mix, fshader_preview.fsh:402), each shown through the postfx kernel, and
takes the reference's keyboard commands:

    up/down/left/right (or u/j/k/l)  orbit the camera   (20 degree steps)
    w/s/a/d                          move the look-at centre (0.4 steps)
    h/n                              dolly in/out
    c                                save the current frame
    r <spp>                          offline render (full integrator) -> image
    f                                write render_args.txt and quit
    q                                quit

A camera command resets the accumulation (frameCounter = 0,
PathTrace.cpp:743-800). A terminal gets single keypresses; piped stdin
gets one command per line. ``--frames N`` renders N frames headless and
writes the image:

    python -m jaderaytracerendering_tpu_torch.cli.preview --frames 8

With no other flag this is the preview's main path: the jade scene with
20,000 statue triangles, 1024x1024, 1 spp per frame, 2 bounces, engine
``mega`` (the preview kernel), 4 bands (each frame renders a quarter of
the pixels). ``f`` then ``cli.render --render-args render_args.txt``
renders the same view offline. ``--device cpu`` runs the plain torch
versions; a missing CUDA device is an error.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import common

ROTATE_DELTA = 20.0  # degrees per keypress (PathTrace.cpp:730 at 1 s)
MOVE_DELTA = 0.4
AUTO_BANDS = 4       # the JAX CLI's auto value (its cli/preview.py:79-89)


class _Display:
    """Pipelined display of the u8 frames (the GL loop's implicit double
    buffering, PathTrace.cpp:1180-1187): a frame's copy to the host is
    queued on a side stream behind that frame's work, and the host waits
    for it only after the next frame has been queued, so the copy of one
    frame overlaps the rendering of the next."""

    def __init__(self, device):
        import torch

        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def submit(self, disp):
        """Queue the copy of ``disp`` -> a handle for ``wait``."""
        import torch

        if self.stream is None:
            return disp, None
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            host = torch.empty(disp.shape, dtype=disp.dtype, pin_memory=True)
            host.copy_(disp, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        disp.record_stream(self.stream)
        return host, done

    @staticmethod
    def wait(handle):
        host, done = handle
        if done is not None:
            done.synchronize()
        return host


def main(argv=None):
    """Run the CLI; returns the final Film and a dict of ``frames``,
    ``seconds`` (the frame loop's wall clock), ``frame_s`` (each frame's
    wall clock, as its FPS line shows it) and, headless, ``display`` (the
    last frame's u8 image on the host, as shown) for in-process callers."""
    ap = argparse.ArgumentParser(prog="jade-preview-torch")
    common.add_common_args(ap)
    ap.add_argument("--frames", type=int, default=0,
                    help="headless: render N progressive frames, write --out, exit")
    ap.add_argument("--out", default="RenderResultCuda.bmp")
    ap.add_argument("--save-every", type=int, default=0,
                    help="write the frame every N frames")
    ap.add_argument("--bands", type=int, default=0,
                    help=f"pixel bands per displayed frame (0 = auto = {AUTO_BANDS} "
                         "where it divides the pixel count)")
    args = ap.parse_args(argv)
    device = common.select_device(args)

    from ..core.camera import OrbitCamera
    from ..core.film import Film
    from ..integrator import render as R
    from ..models import demo
    from ..post import image_io, tonemap
    from ..scene import serialization
    from ..scene.scene import assemble

    objects, env, cam = common.load_scene(args)
    if not isinstance(cam, OrbitCamera):
        common.stage("note: serialized camera loaded; orbit controls start from default")
        cam = OrbitCamera()
    # preview frames use the 2-bounce no-NEE integrator
    # (fshader_preview.fsh:332-375); 'r' renders use the full one
    cfg = common.config_from_args(args).replace(integrator="preview")
    if args.spp is None:
        cfg = cfg.replace(spp=1, spp_batch=1)
    bands = args.bands or AUTO_BANDS
    if bands > 1 and (cfg.width * cfg.height) % bands == 0:
        cfg = cfg.replace(preview_bands=bands)
    sd = assemble(objects, env, leaf_size=cfg.bvh_leaf_size, device=device)
    common.stage(f"scene: {sd.n_triangles} tris, {sd.n_nodes} nodes ({sd.bvh_builder} "
                 f"builder), {sd.n_emit} lights, "
                 f"{cfg.width}x{cfg.height}, {cfg.preview_bands} bands, engine "
                 f"{cfg.engine}, device {device}")

    film = Film.create(cfg.height, cfg.width, device)
    frame = 0
    bframe = 0  # band rotation counter; resets with the film
    display = _Display(device)
    pending = None  # the previous frame's display copy
    frame_s = []
    t_last = t_start = time.perf_counter()

    def save(path, the_film):
        # film row 0 is the bottom row; a CUDA film is finished on the card
        image_io.save(path, tonemap.finalize(the_film.mean(), cfg.tonemap, flip=True))
        common.stage(f"wrote {path}")

    def step():
        nonlocal film, frame, bframe, t_last, pending
        film, disp = R.render_film_preview(sd, cam, cfg.replace(spp=cfg.spp_batch), film=film,
                                           display=True, frame_idx=bframe)
        bframe += 1
        handle = display.submit(disp)
        # the previous frame's image is on the host once its copy is done;
        # this frame renders meanwhile (the first frame waits for itself)
        display.wait(pending if pending is not None else handle)
        pending = handle
        frame += 1
        now = time.perf_counter()
        # the reference's per-frame FPS line (PathTrace.cpp:677-680)
        print(f"FPS : {1.0 / max(now - t_last, 1e-9):.2f}    Iter time: {frame}", flush=True)
        frame_s.append(now - t_last)
        t_last = now

    if args.frames > 0:
        for _ in range(args.frames):
            step()
            if args.save_every and frame % args.save_every == 0:
                save(args.out, film)
        shown = display.wait(pending)
        seconds = time.perf_counter() - t_start
        save(args.out, film)
        return film, {"frames": frame, "seconds": seconds, "frame_s": frame_s,
                      "display": shown}

    common.stage("interactive preview: commands = arrows(u/j/k/l) wasd h n c r f q")
    # a terminal: single keypresses at frame rate, the reference's GLFW key
    # polling with held-key orbiting (PathTrace.cpp:729-851); piped stdin
    # (tests, scripting) keeps the line protocol
    tty_fd = saved_termios = None
    if sys.stdin.isatty():
        import termios
        import tty as tty_mod

        tty_fd = sys.stdin.fileno()
        saved_termios = termios.tcgetattr(tty_fd)
        tty_mod.setcbreak(tty_fd)
    try:
        while True:
            step()
            if tty_fd is not None:
                key = _read_tty_command()
                tok = None if key is None else [key]
            else:
                tok = _read_line_command()
            if tok is None:
                continue
            cmd = tok[0].lower()
            moved = True
            if cmd in ("q", "esc"):
                break
            elif cmd in ("up", "u"):
                cam.orbit(d_up=ROTATE_DELTA)
            elif cmd in ("down", "j"):
                cam.orbit(d_up=-ROTATE_DELTA)
            elif cmd in ("left", "k"):
                cam.orbit(d_rotate=ROTATE_DELTA)
            elif cmd in ("right", "l"):
                cam.orbit(d_rotate=-ROTATE_DELTA)
            elif cmd == "w":
                cam.move_center(dy=MOVE_DELTA)
            elif cmd == "s":
                cam.move_center(dy=-MOVE_DELTA)
            elif cmd == "a":
                cam.move_center(dx=-MOVE_DELTA)
            elif cmd == "d":
                cam.move_center(dx=MOVE_DELTA)
            elif cmd == "h":
                cam.dolly(-MOVE_DELTA)
            elif cmd == "n":
                cam.dolly(MOVE_DELTA)
            elif cmd == "c":
                save(args.out, film)
                moved = False
            elif cmd == "r":
                spp = int(tok[1]) if len(tok) > 1 else 64
                common.stage(f"offline render at {spp}spp...")
                save(args.out, R.render_film(sd, cam, cfg.replace(
                    spp=spp, max_depth=16, integrator="full")))
                moved = False
            elif cmd == "f":
                spec = serialization.SceneSpec(
                    eye=cam.eye, camera_rotate=cam.camera_rotate,
                    objects=demo.to_spec(demo.DemoScene(objects=objects, env_map=env,
                                                        camera=cam)).objects)
                serialization.write_render_args("render_args.txt", spec)
                common.stage("Saving Cuda Render Args")  # PathTrace.cpp:840
                break
            else:
                common.stage(f"unknown command {cmd!r}")
                moved = False
            if moved:
                film = Film.create(cfg.height, cfg.width, device)  # frameCounter = 0
                bframe = 0  # restart the band rotation with the film
                pending = None  # do not show a frame from before the move
    finally:
        if saved_termios is not None:
            import termios

            termios.tcsetattr(tty_fd, termios.TCSADRAIN, saved_termios)
    return film, {"frames": frame, "seconds": time.perf_counter() - t_start,
                  "frame_s": frame_s}


def _read_tty_command():
    """One cbreak keypress -> command token (arrow escape sequences map to
    the orbit keys); None when no input is pending."""
    import os
    import select

    if not select.select([sys.stdin], [], [], 0)[0]:
        return None
    ch = os.read(sys.stdin.fileno(), 1).decode(errors="ignore")
    if ch == "\x1b":  # arrow keys: ESC [ A/B/C/D
        seq = ""
        for _ in range(2):
            if select.select([sys.stdin], [], [], 0.01)[0]:
                seq += os.read(sys.stdin.fileno(), 1).decode(errors="ignore")
        return {"[A": "up", "[B": "down", "[D": "left", "[C": "right"}.get(seq, "esc")
    return ch.lower() if ch.strip() else None


def _read_line_command():
    import select

    if not select.select([sys.stdin], [], [], 0)[0]:
        return None
    line = sys.stdin.readline()
    if not line:
        return None
    tok = line.strip().split()
    return tok if tok else None


if __name__ == "__main__":
    main()
