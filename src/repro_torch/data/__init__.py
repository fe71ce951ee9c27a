"""Host-side data: synthetic KG datasets and the blocked-CSR layout."""
