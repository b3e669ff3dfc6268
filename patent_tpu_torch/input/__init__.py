"""Host-side image input: decode, decoded-u8 cache, native decoder."""
