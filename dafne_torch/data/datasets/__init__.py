"""The dataset families read from disk: DOTA, HRSC2016, UCAS-AOD, ICDAR15."""
