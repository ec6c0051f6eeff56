"""Host-side data: sequence packing by list ranking, and the synthetic
packed-LM pipeline."""
