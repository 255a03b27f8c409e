"""The port's native host runtime (:mod:`svoc_torch.runtime.native`)."""

from svoc_torch.runtime.native import (  # noqa: F401
    NativeHashingTokenizer,
    load_native_library,
    native_pack_tokens_raw,
)
