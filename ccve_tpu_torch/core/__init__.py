"""Host-side data model and workload generators."""
