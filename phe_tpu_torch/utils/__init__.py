"""Host-side utilities: exact number theory and limb packing."""
