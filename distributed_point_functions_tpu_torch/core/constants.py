"""Fixed PRG keys shared with the reference implementation.

These are the first halves of SHA256 sums of the constant names (with a
trailing newline, as produced by `echo name | sha256sum`); the values must
match reference dpf/distributed_point_function.cc:37-42 exactly so that
keys generated by either implementation evaluate identically in the other.
tests/test_torch_keys.py holds them equal to the JAX package's copy, which
tests/test_aes.py re-derives from hashlib.
"""

from .uint128 import make_uint128

PRG_KEY_LEFT = make_uint128(0x5BE037CCF6A03DE5, 0x935F08D0A5B6A2FD)
PRG_KEY_RIGHT = make_uint128(0xEF94B6AEDEBB026C, 0xE2EA1FE0F66F4D0B)
PRG_KEY_VALUE = make_uint128(0x05A5D1588C5423E3, 0x46A31101B21D1C98)
