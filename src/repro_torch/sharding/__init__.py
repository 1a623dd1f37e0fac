"""Logical-axis sharding of the port: ``rules`` resolves logical axis
names to mesh axes and DTensor placements, ``axes`` names the logical
axes of whole trees (params, caches, batches)."""
