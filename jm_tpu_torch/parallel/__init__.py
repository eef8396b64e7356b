"""jm_tpu's parallel axes over a list of torch devices in one process:
MB-row sharding of the md_low P step (sp_pipeline) and closed GOPs on
the rows of a (dp, sp) mesh (gop_pipeline)."""
