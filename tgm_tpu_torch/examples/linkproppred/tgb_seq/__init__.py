"""The tgb_seq EdgeBank script of the port."""
