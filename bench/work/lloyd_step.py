"""Work of one ``lloyd_step`` call: ``lloyd_step(x (n, d), w (n,), c (k,
d))`` -> (sums (k, d), counts (k,), assignment (n,) i32, dist (n,) f32).
2 n k d operations for the assignment and 2 n d for the weighted sums; x,
w (f32) and c read once, the four outputs written once."""


def work(shapes: list, itemsize: int) -> tuple[float, float]:
    (n, d), _, (k, _) = shapes[0], shapes[1], shapes[2]
    return (2.0 * n * k * d + 2.0 * n * d,
            float(itemsize * (n * d + k * d) + 4 * n
                  + 4 * (k * d + k) + 8 * n))
