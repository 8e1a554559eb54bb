"""Work of one ``min_argmin`` call: ``min_argmin(x (n, d), c (m, d))`` ->
(dist (n,) f32, idx (n,) i32).  2 n m d operations; x and c read once,
8 n bytes written."""


def work(shapes: list, itemsize: int) -> tuple[float, float]:
    (n, d), (m, _) = shapes[0], shapes[1]
    return (2.0 * n * m * d,
            float(itemsize * (n * d + m * d) + 8 * n))
