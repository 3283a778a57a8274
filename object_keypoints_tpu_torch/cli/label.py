"""Keypoint labeling CLI: the flags of scripts/label.py.

    python -m object_keypoints_tpu_torch.cli.label data/sequences [--calibration cal.yaml]

The reference is a hud/OpenGL click GUI; here the frontend is matplotlib's
event loop, and the math (frame-pair selection, two-view triangulation,
undo, saving) is ``labeling.LabelingSession`` either way. Without a display
(``DISPLAY`` unset) the CLI exits with a message and imports no matplotlib:
headless labeling is ``LabelingSession``'s ``add_point`` / ``undo`` /
``save``. matplotlib and cv2 are imported in GUI mode only.

Keys (GUI mode): click the left pane, then the right pane, alternately;
u = undo, s = triangulate + save + show the backprojections, q/tab = next
sequence.
"""

import argparse
import os

from object_keypoints_tpu_torch.labeling import LabelingSession

HEADLESS_MESSAGE = ("label needs an interactive display. Headless labeling is available "
                    "programmatically via object_keypoints_tpu_torch.labeling.LabelingSession "
                    "(add_point / undo / save).")


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("base_dir", help="Directory with encoded sequence directories.")
    parser.add_argument("--calibration", type=str, default=None,
                        help="Kalibr calibration (defaults to the sequence's).")
    return parser.parse_args(argv)


def _read_frame(sequence_dir, index):
    import cv2

    path = os.path.join(sequence_dir, "frames_preview.mp4")
    if not os.path.exists(path):
        path = os.path.join(sequence_dir, "frames.mp4")
    capture = cv2.VideoCapture(path)
    capture.set(cv2.CAP_PROP_POS_FRAMES, index)
    ok, frame = capture.read()
    capture.release()
    if not ok:
        raise RuntimeError(f"could not read frame {index} of {path}")
    return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)


def label_sequence_gui(sequence_dir, calibration):
    from matplotlib import pyplot

    session = LabelingSession(sequence_dir, calibration)
    left = _read_frame(sequence_dir, session.left_frame_index)
    right = _read_frame(sequence_dir, session.right_frame_index)

    fig, (ax_l, ax_r) = pyplot.subplots(1, 2, figsize=(16, 6))
    ax_l.imshow(left)
    ax_r.imshow(right)
    ax_l.set_title("left frame — click keypoints")
    ax_r.set_title("right frame — click matching keypoints")

    def redraw():
        for ax, pts in ((ax_l, session.left_keypoints), (ax_r, session.right_keypoints)):
            for artist in list(ax.lines):
                artist.remove()
            for p in pts:
                ax.plot(p[0], p[1], "r+", markersize=12)
        fig.canvas.draw_idle()

    def on_click(event):
        if event.inaxes is ax_l:
            session.add_point("left", (event.xdata, event.ydata))
        elif event.inaxes is ax_r:
            session.add_point("right", (event.xdata, event.ydata))
        redraw()

    def on_key(event):
        if event.key == "u":
            session.undo()
            redraw()
        elif event.key == "s":
            out = session.save()
            print(f"saved {out}")
            back_l = session.backproject(session.left_frame_index)
            back_r = session.backproject(session.right_frame_index)
            ax_l.scatter(back_l[:, 0], back_l[:, 1], c="b", marker="x")
            ax_r.scatter(back_r[:, 0], back_r[:, 1], c="b", marker="x")
            fig.canvas.draw_idle()
        elif event.key in ("q", "tab"):
            pyplot.close(fig)

    fig.canvas.mpl_connect("button_press_event", on_click)
    fig.canvas.mpl_connect("key_press_event", on_key)
    pyplot.show()


def main(argv=None):
    flags = read_args(argv)
    if not os.environ.get("DISPLAY"):
        raise SystemExit(HEADLESS_MESSAGE)
    sequences = sorted(os.path.join(flags.base_dir, d) for d in os.listdir(flags.base_dir))
    for seq in sequences:
        print(f"labeling {seq}")
        label_sequence_gui(seq, flags.calibration)


if __name__ == "__main__":
    main()
