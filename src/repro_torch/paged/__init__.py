"""Paged KV cache and its host-side page allocator."""
