"""Host-side data: the synthetic trajectory, the transforms, collation."""
