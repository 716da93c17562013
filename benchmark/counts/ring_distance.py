"""Stage 3's ring distances, counted from shapes.

Per pair, both patches pool through the whole bank: two products of
(n_filters x n_pixels) by (n_pixels x n_bins), 2 operations a
multiply-add. The truncation, squared difference and ring sums are
elementwise work on the (n_filters x n_bins) result and are not counted.
Bytes: the bank read once, each patch (uint8) read once, each row of
n_rings f32 written once.
"""


def flops(pairs: int, n_filters: int, n_pixels: int, n_bins: int) -> float:
    return 2.0 * 2.0 * n_filters * n_pixels * n_bins * pairs


def bytes_moved(pairs: int, n_filters: int, n_pixels: int, n_rings: int,
                bank_bytes_per_value: int = 4) -> float:
    return (n_filters * n_pixels * bank_bytes_per_value
            + 2.0 * n_pixels * pairs + 4.0 * n_rings * pairs)
