#!/usr/bin/env python
"""Write the photo world's nine source photos for the PyTorch port.

``cerebro_tpu.photoworld.load_photos()`` builds them from sample images that
ship with scikit-learn and matplotlib, decoded with OpenCV. The port
(``cerebro_tpu_torch/photoworld.py``) must run where those packages are
absent, so it reads this file instead:

    python scripts/export_photoworld_photos.py   # writes artifacts/photoworld_photos.npz

The npz holds ``photo_0`` .. ``photo_8``, each the contrast-normalized f32
array ``load_photos()`` returns, in its order, compressed.
tests/test_torch_photoworld.py holds the file equal to ``load_photos()``.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUT = os.path.join(REPO, "artifacts", "photoworld_photos.npz")


def main() -> int:
    from cerebro_tpu.photoworld import load_photos

    photos = load_photos()
    np.savez_compressed(OUT, **{f"photo_{k}": p for k, p in enumerate(photos)})
    print(f"wrote {len(photos)} photos to {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
