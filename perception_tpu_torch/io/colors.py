"""Named-color lookup for label visualization.

Counterpart of ``perception_tpu/io/colors.py`` (cv_bridge's
``rgb_colors::getRGBColor``: a 146-entry named-color table indexed modulo
146, used by ``cvtColorForDisplay`` to colorize 32SC1 label images). The
table is the CSS4 color keywords in alphabetical order without the two
aliases (``cyan`` == ``aqua``, ``magenta`` == ``fuchsia``), stored here as
literals: the JAX module reads them from matplotlib, which this package
does not import.

``get_rgb_color`` and ``label_image_to_rgb8`` take numpy arrays or tensors
on any device and answer in kind.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

_HEX = (
    ("aliceblue", "#F0F8FF"), ("antiquewhite", "#FAEBD7"), ("aqua", "#00FFFF"),
    ("aquamarine", "#7FFFD4"), ("azure", "#F0FFFF"), ("beige", "#F5F5DC"), ("bisque", "#FFE4C4"),
    ("black", "#000000"), ("blanchedalmond", "#FFEBCD"), ("blue", "#0000FF"),
    ("blueviolet", "#8A2BE2"), ("brown", "#A52A2A"), ("burlywood", "#DEB887"),
    ("cadetblue", "#5F9EA0"), ("chartreuse", "#7FFF00"), ("chocolate", "#D2691E"),
    ("coral", "#FF7F50"), ("cornflowerblue", "#6495ED"), ("cornsilk", "#FFF8DC"),
    ("crimson", "#DC143C"), ("darkblue", "#00008B"), ("darkcyan", "#008B8B"),
    ("darkgoldenrod", "#B8860B"), ("darkgray", "#A9A9A9"), ("darkgreen", "#006400"),
    ("darkgrey", "#A9A9A9"), ("darkkhaki", "#BDB76B"), ("darkmagenta", "#8B008B"),
    ("darkolivegreen", "#556B2F"), ("darkorange", "#FF8C00"), ("darkorchid", "#9932CC"),
    ("darkred", "#8B0000"), ("darksalmon", "#E9967A"), ("darkseagreen", "#8FBC8F"),
    ("darkslateblue", "#483D8B"), ("darkslategray", "#2F4F4F"), ("darkslategrey", "#2F4F4F"),
    ("darkturquoise", "#00CED1"), ("darkviolet", "#9400D3"), ("deeppink", "#FF1493"),
    ("deepskyblue", "#00BFFF"), ("dimgray", "#696969"), ("dimgrey", "#696969"),
    ("dodgerblue", "#1E90FF"), ("firebrick", "#B22222"), ("floralwhite", "#FFFAF0"),
    ("forestgreen", "#228B22"), ("fuchsia", "#FF00FF"), ("gainsboro", "#DCDCDC"),
    ("ghostwhite", "#F8F8FF"), ("gold", "#FFD700"), ("goldenrod", "#DAA520"), ("gray", "#808080"),
    ("green", "#008000"), ("greenyellow", "#ADFF2F"), ("grey", "#808080"), ("honeydew", "#F0FFF0"),
    ("hotpink", "#FF69B4"), ("indianred", "#CD5C5C"), ("indigo", "#4B0082"), ("ivory", "#FFFFF0"),
    ("khaki", "#F0E68C"), ("lavender", "#E6E6FA"), ("lavenderblush", "#FFF0F5"),
    ("lawngreen", "#7CFC00"), ("lemonchiffon", "#FFFACD"), ("lightblue", "#ADD8E6"),
    ("lightcoral", "#F08080"), ("lightcyan", "#E0FFFF"), ("lightgoldenrodyellow", "#FAFAD2"),
    ("lightgray", "#D3D3D3"), ("lightgreen", "#90EE90"), ("lightgrey", "#D3D3D3"),
    ("lightpink", "#FFB6C1"), ("lightsalmon", "#FFA07A"), ("lightseagreen", "#20B2AA"),
    ("lightskyblue", "#87CEFA"), ("lightslategray", "#778899"), ("lightslategrey", "#778899"),
    ("lightsteelblue", "#B0C4DE"), ("lightyellow", "#FFFFE0"), ("lime", "#00FF00"),
    ("limegreen", "#32CD32"), ("linen", "#FAF0E6"), ("maroon", "#800000"),
    ("mediumaquamarine", "#66CDAA"), ("mediumblue", "#0000CD"), ("mediumorchid", "#BA55D3"),
    ("mediumpurple", "#9370DB"), ("mediumseagreen", "#3CB371"), ("mediumslateblue", "#7B68EE"),
    ("mediumspringgreen", "#00FA9A"), ("mediumturquoise", "#48D1CC"),
    ("mediumvioletred", "#C71585"), ("midnightblue", "#191970"), ("mintcream", "#F5FFFA"),
    ("mistyrose", "#FFE4E1"), ("moccasin", "#FFE4B5"), ("navajowhite", "#FFDEAD"),
    ("navy", "#000080"), ("oldlace", "#FDF5E6"), ("olive", "#808000"), ("olivedrab", "#6B8E23"),
    ("orange", "#FFA500"), ("orangered", "#FF4500"), ("orchid", "#DA70D6"),
    ("palegoldenrod", "#EEE8AA"), ("palegreen", "#98FB98"), ("paleturquoise", "#AFEEEE"),
    ("palevioletred", "#DB7093"), ("papayawhip", "#FFEFD5"), ("peachpuff", "#FFDAB9"),
    ("peru", "#CD853F"), ("pink", "#FFC0CB"), ("plum", "#DDA0DD"), ("powderblue", "#B0E0E6"),
    ("purple", "#800080"), ("rebeccapurple", "#663399"), ("red", "#FF0000"),
    ("rosybrown", "#BC8F8F"), ("royalblue", "#4169E1"), ("saddlebrown", "#8B4513"),
    ("salmon", "#FA8072"), ("sandybrown", "#F4A460"), ("seagreen", "#2E8B57"),
    ("seashell", "#FFF5EE"), ("sienna", "#A0522D"), ("silver", "#C0C0C0"), ("skyblue", "#87CEEB"),
    ("slateblue", "#6A5ACD"), ("slategray", "#708090"), ("slategrey", "#708090"),
    ("snow", "#FFFAFA"), ("springgreen", "#00FF7F"), ("steelblue", "#4682B4"), ("tan", "#D2B48C"),
    ("teal", "#008080"), ("thistle", "#D8BFD8"), ("tomato", "#FF6347"), ("turquoise", "#40E0D0"),
    ("violet", "#EE82EE"), ("wheat", "#F5DEB3"), ("white", "#FFFFFF"), ("whitesmoke", "#F5F5F5"),
    ("yellow", "#FFFF00"), ("yellowgreen", "#9ACD32"),
)

_NAMES = [name for name, _ in _HEX]
_TABLE = np.array(
    [tuple(int(h[i : i + 2], 16) / 255.0 for i in (1, 3, 5)) for _, h in _HEX], dtype=np.float64
)
_TABLE8 = (_TABLE * 255.0 + 0.5).astype(np.uint8)  # label_image_to_rgb8's colours

N_COLORS = len(_TABLE)


def color_name(index: int) -> str:
    """Name of color ``index % N_COLORS`` (alphabetical CSS3 order)."""
    return _NAMES[int(index) % N_COLORS]


def get_rgb_color(index: int) -> np.ndarray:
    """RGB in [0, 1] for an integer label (wraps modulo the table size),
    mirroring ``rgb_colors::getRGBColor`` (rgb_colors.cpp:46)."""
    return _TABLE[int(index) % N_COLORS].copy()


def label_image_to_rgb8(labels: Union[np.ndarray, torch.Tensor], background: int = -1):
    """Colorize an integer label image (H, W) into (H, W, 3) uint8.

    Equivalent of cvtColorForDisplay's 32SC1 branch (cv_bridge.cpp):
    each label gets a distinct named color; ``background`` labels map to
    black. A tensor is colorized by a gather on its own device.
    """
    if isinstance(labels, torch.Tensor):
        table = torch.as_tensor(_TABLE8, device=labels.device)
        bg = labels == background
        out = table[torch.where(bg, 0, labels.long() % N_COLORS)]
        return torch.where(bg[..., None], 0, out).to(torch.uint8)
    labels = np.asarray(labels)
    idx = np.where(labels == background, 0, labels % N_COLORS)
    out = _TABLE8[idx]
    out[labels == background] = 0
    return out
