"""Node-property-prediction examples of the port."""
