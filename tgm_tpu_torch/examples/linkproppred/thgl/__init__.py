"""The thgl EdgeBank script of the port."""
