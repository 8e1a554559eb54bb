"""Algorithms of the paper (Alg. 1/2/3, k-means++, k-means--), ported from
``repro.core``: plain torch around the dispatched kernel ops."""
