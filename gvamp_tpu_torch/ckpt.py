"""Run-end scalar histories of the port (``gvamp_tpu/ckpt.py:175-184``).

Only ``write_scalar_history`` is here: the full-state checkpoints
(``--checkpoint`` / ``--resume``) are ROADMAP.md Queue 1 item 4.
"""

from __future__ import annotations

import numpy as np

from gvamp_tpu_torch.io import vecio


def write_scalar_history(prefix: str, history) -> None:
    """gam1s/gam2s CSVs at run end, + R2trains when the engine records it
    (vamp.cpp:778-794)."""
    vecio.write_txt(prefix + "_gam1s.csv", np.array([h["gam1"] for h in history]))
    vecio.write_txt(prefix + "_gam2s.csv", np.array([h["gam2"] for h in history]))
    if "R2_train_1" in history[0]:
        r2s = []
        for h in history:  # err_measures pushes R2 after each half-step
            r2s += [float(h["R2_train_1"]), float(h["R2_train_2"])]
        vecio.write_txt(prefix + "_R2trains.csv", np.array(r2s))
