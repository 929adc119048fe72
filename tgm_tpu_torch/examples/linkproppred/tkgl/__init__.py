"""The tkgl EdgeBank script of the port."""
