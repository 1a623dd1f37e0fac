"""KVFetcher core: codec, fetch plans and fetching-aware scheduling."""
