"""Link-prediction examples of the port."""
