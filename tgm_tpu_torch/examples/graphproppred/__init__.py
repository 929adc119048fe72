"""Graph-property-prediction examples of the port."""
