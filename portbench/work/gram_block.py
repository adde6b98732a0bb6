"""Kernel 3, the RBF Gram (``csrc/gram_block.cu``): the cross Gram of a
predict, k(Xq, X), and the symmetric Gram of a bank entry, k(X, X).

Cross (m x n at d features): both inputs read once, m n values written,
2 m n d operations of the products and 6 an entry.  Symmetric (l x l):
l (l + 1) / 2 products of d, 6 operations an entry, l^2 values written
and X read once.
"""

KERNEL = "gram_kernel"
WRAPPERS = ("gram_block",)


def cross(m: int, n: int, d: int, item: int) -> tuple:
    """(bytes, operations) of one cross launch."""
    return (m * d + n * d + m * n) * item, 2 * m * n * d + 6 * m * n


def symmetric(l: int, d: int, item: int) -> tuple:
    """(bytes, operations) of one symmetric launch (a bank entry)."""
    return (l * l + l * d) * item, l * (l + 1) * d + 6 * l * l
