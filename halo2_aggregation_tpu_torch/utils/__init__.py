"""Host-side utilities: Fiat-Shamir transcript, serialization, profiling."""
