"""Host-side data preparation of the port."""
