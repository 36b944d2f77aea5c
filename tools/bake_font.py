"""Bake the UI glyph atlas (renderer_tpu/ui/font_atlas.npz) from Pillow's
built-in bitmap font.

The renderer loads the baked atlas and never imports Pillow. Re-run only to
change the font; the UI goldens depend on these bytes:
    python -m tools.bake_font
"""

from __future__ import annotations

import numpy as np

from renderer_tpu.ui.font import ASCII_FIRST, ASCII_LAST, ATLAS_PATH


def bake() -> dict[str, np.ndarray]:
    from PIL import Image, ImageDraw, ImageFont

    pil_font = ImageFont.load_default()
    chars = [chr(c) for c in range(ASCII_FIRST, ASCII_LAST + 1)]

    # measure
    probe = Image.new("L", (64, 64))
    draw = ImageDraw.Draw(probe)
    boxes = {}
    max_h = 1
    for ch in chars:
        x0, y0, x1, y1 = draw.textbbox((0, 0), ch, font=pil_font)
        w = max(int(x1), 1)
        h = max(int(y1), 1)
        boxes[ch] = (w, h)
        max_h = max(max_h, h)
    line_height = max_h + 2

    # rasterize one row per 16 glyphs
    cols = 16
    cell_w = max(w for w, _ in boxes.values()) + 1
    rows = (len(chars) + cols - 1) // cols
    img = Image.new("L", (cols * cell_w, rows * line_height), 0)
    draw = ImageDraw.Draw(img)
    origins = np.zeros((len(chars), 2), np.int32)
    widths = np.zeros(len(chars), np.int32)
    for i, ch in enumerate(chars):
        cx = (i % cols) * cell_w
        cy = (i // cols) * line_height
        draw.text((cx, cy), ch, fill=255, font=pil_font)
        origins[i] = (cx, cy)
        widths[i] = boxes[ch][0]
    return {"coverage": np.asarray(img, np.uint8), "origins": origins,
            "widths": widths, "line_height": np.int32(line_height)}


if __name__ == "__main__":
    np.savez_compressed(ATLAS_PATH, **bake())
    print(f"wrote {ATLAS_PATH}")
