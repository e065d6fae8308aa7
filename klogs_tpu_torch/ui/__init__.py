"""Terminal output for the port (copies of klogs_tpu.ui.term/widgets)."""
