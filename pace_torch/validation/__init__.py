"""Validation runs of the port against published and recorded behaviour:
the Jablonowski & Williamson baroclinic wave's day-1 digest
(`jw_day1`) and its nine-day evolution (`jw_baroclinic_wave`)."""
