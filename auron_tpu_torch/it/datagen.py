"""Deterministic TPC-DS-subset data (counterpart of
auron_tpu/it/datagen.py), in numpy alone.

`generate` makes the JAX package's star schema bit for bit: the same
`np.random.default_rng(seed)` draws in the same order, so every value
equals the JAX generator's, and the same `Catalog` (each table's schema
as the JAX package reads it off the arrow table, nullable columns, and
its chunk paths `<data_dir>/<table>/part-<k>.parquet`).  Nothing is
written: the tables come back as host columns, in the layout
`SourceTable.from_rows` documents (strings as object arrays of `str`,
`d_date` as int32 days, `t_meal_time`'s nulls as validity false), and
chunk k of a table holds the rows `chunk_bounds` gives it, as the JAX
generator slices its parquet files.

`TableEngine` is the foreign engine that serves the catalog's scans
from those columns (the scan side of the JAX package's pyarrow oracle):
with `converters.ScanSourceProvider` registered, the port's
`AuronSession.execute` runs a corpus query over the generated tables.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend.foreign import ForeignExpr, ForeignNode
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.ops.scan.ipc import SourceTable

I32 = DataType.int32()
I64 = DataType.int64()
F64 = DataType.float64()
STR = DataType.string()
DATE = DataType.date32()

# bump when the generator's tables/columns/shapes change (the JAX
# generator's version of the same tables)
_DATAGEN_VERSION = 2

_DAY_NAMES = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
              "Friday", "Saturday")
_CATEGORIES = ("Books", "Home", "Electronics", "Jewelry", "Music",
               "Shoes", "Sports", "Women", "Men", "Children")
_STATES = ("TN", "CA", "TX", "OH", "GA", "MI", "NY", "WA", "IL", "FL")
_COUNTRIES = ("United States", "Canada", "Mexico", "Germany", "Japan")
_CHANNELS = ("N", "Y")

# a table as the generator builds it: column name -> values (a numpy
# array, `_strs`' object array or `_dates`' int32 days), in schema order
Columns = Dict[str, object]
# the generated tables: name -> (arrays, validities), in schema order
Tables = Dict[str, Tuple[List[np.ndarray], List[np.ndarray]]]


@dataclass
class TableDef:
    name: str
    schema: Schema
    chunks: List[str] = field(default_factory=list)   # parquet paths


@dataclass
class Catalog:
    """Every table's schema and file chunks; builds the scans."""

    data_dir: str
    tables: Dict[str, TableDef] = field(default_factory=dict)

    def scan(self, table: str, columns: Optional[Sequence[str]] = None,
             pushed_filters: Sequence[ForeignExpr] = (),
             parts: Optional[int] = None) -> ForeignNode:
        t = self.tables[table]
        cols = list(columns) if columns is not None else t.schema.names()
        fields = {f.name: f for f in t.schema.fields}
        out = Schema(tuple(fields[c] for c in cols))
        n = parts or len(t.chunks)
        groups: List[List[str]] = [[] for _ in range(min(n, len(t.chunks)))]
        for i, path in enumerate(t.chunks):
            groups[i % len(groups)].append(path)
        return ForeignNode(
            "FileSourceScanExec", output=out,
            attrs={"format": "parquet",
                   "file_groups": [list(g) for g in groups],
                   "pushed_filters": list(pushed_filters)})

    def field(self, table: str, column: str) -> Field:
        for f in self.tables[table].schema.fields:
            if f.name == column:
                return f
        raise KeyError(f"{table}.{column}")


class _Dates(np.ndarray):
    """int32 days since 1970-01-01 that the schema types as a date."""


def _dates(days: np.ndarray) -> np.ndarray:
    return np.asarray(days, dtype=np.int32).view(_Dates)


def _strs(values: Sequence[Optional[str]]) -> np.ndarray:
    """A string column as an object array (None where null)."""
    a = np.empty(len(values), dtype=object)
    a[:] = values
    return a


_DTYPES = {np.dtype(np.int64): I64, np.dtype(np.int32): I32,
           np.dtype(np.float64): F64}


def _dtype(values: np.ndarray) -> DataType:
    if isinstance(values, _Dates):
        return DATE
    if values.dtype == object:
        return STR
    return _DTYPES[values.dtype]


def chunk_bounds(n_rows: int, n_chunks: int) -> np.ndarray:
    """Row bounds of a table's chunks: chunk k holds rows [b[k], b[k+1]),
    as the JAX generator slices its parquet files."""
    return np.linspace(0, n_rows, n_chunks + 1).astype(int)


def _add(tables: Tables, out_dir: str, name: str, cols: Columns,
         n_chunks: int) -> TableDef:
    """Keep a generated table's columns and return its definition: the
    schema the JAX package reads off the arrow table (every column
    nullable) and the chunk paths it writes."""
    n = len(next(iter(cols.values())))
    n_chunks = max(1, min(n_chunks, max(1, n)))
    arrays, validities, fields = [], [], []
    for cname, values in cols.items():
        fields.append(Field(cname, _dtype(values)))
        if isinstance(values, _Dates):
            values = values.view(np.ndarray)
        valid = np.ones(n, bool)
        if values.dtype == object:
            valid = np.array([v is not None for v in values], dtype=bool)
        arrays.append(values)
        validities.append(valid)
    tables[name] = (arrays, validities)
    paths = [os.path.join(out_dir, name, f"part-{i:05d}.parquet")
             for i in range(n_chunks)]
    return TableDef(name=name, schema=Schema(tuple(fields)), chunks=paths)


def generate(data_dir: str, sf: float = 0.01, seed: int = 7,
             fact_chunks: int = 4) -> Tuple[Catalog, Tables]:
    """The star schema at scale factor `sf`, as the JAX package's
    `generate` makes it, bit for bit: its `Catalog` (chunk paths under
    `data_dir`; nothing is written) and every table's host columns."""
    tables: Tables = {}
    rng = np.random.default_rng(seed)
    cat = Catalog(data_dir=data_dir)

    # ---- date_dim: 5 years of days, 1998-2002 (TPC-DS's window) ----------
    # d_date_sk 2450815 == 1998-01-01, the real dsdgen anchor, so the
    # reference's query date literals land inside the generated window
    n_days = 5 * 365
    sk = np.arange(n_days, dtype=np.int64) + 2450815
    day_idx = np.arange(n_days)
    doy = day_idx % 365
    year = 1998 + day_idx // 365
    moy = np.minimum(doy // 30 + 1, 12)
    dom = doy % 30 + 1
    epoch_1998 = 10227          # days from 1970-01-01 to 1998-01-01
    date_dim = {
        "d_date_sk": sk,
        "d_date": _dates((day_idx + epoch_1998).astype(np.int32)),
        "d_year": year.astype(np.int32),
        "d_moy": moy.astype(np.int32),
        "d_dom": dom.astype(np.int32),
        "d_qoy": ((moy - 1) // 3 + 1).astype(np.int32),
        "d_dow": (day_idx % 7).astype(np.int32),
        # month/week sequence anchors from real dsdgen (1998-01 = 1177,
        # week of 1998-01-01 = 5270) so +1..+11 month-window arithmetic
        # in the reference queries stays in-domain
        "d_month_seq": ((year - 1998) * 12 + moy - 1 + 1177)
        .astype(np.int32),
        "d_week_seq": (day_idx // 7 + 5270).astype(np.int32),
        "d_quarter_name": _strs(
            [f"{int(y)}Q{int((m - 1) // 3 + 1)}"
             for y, m in zip(year, moy)]),
        "d_day_name": _strs([_DAY_NAMES[int(i) % 7] for i in doy]),
    }
    cat.tables["date_dim"] = _add(tables, data_dir, "date_dim", date_dim, 1)

    # ---- item -------------------------------------------------------------
    n_item = max(200, int(2000 * max(sf, 0.01)))
    isk = np.arange(n_item, dtype=np.int64) + 1
    i_price = np.round(rng.uniform(0.5, 100.0, n_item), 2)
    i_manufact_id = rng.integers(1, 1001, n_item).astype(np.int32)
    _COLORS = ("red", "blue", "green", "yellow", "black", "white",
               "purple", "orange", "pink", "brown", "navy", "chartreuse")
    _SIZES = ("small", "medium", "large", "extra large", "economy",
              "N/A", "petite")
    _UNITS = ("Each", "Dozen", "Case", "Pallet", "Gross", "Box")
    item = {
        "i_item_sk": isk,
        "i_item_id": _strs([f"AAAAAAAA{i:08d}" for i in isk]),
        "i_item_desc": _strs([f"item description {int(i)}"
                              for i in isk]),
        "i_category": _strs([_CATEGORIES[int(i) % len(_CATEGORIES)]
                             for i in isk]),
        "i_category_id": (isk % len(_CATEGORIES) + 1).astype(np.int32),
        "i_brand": _strs([f"brand#{int(i) % 50}" for i in isk]),
        "i_brand_id": (isk % 50 + 5001001).astype(np.int32),
        "i_class": _strs([f"class#{int(i) % 20}" for i in isk]),
        "i_class_id": (isk % 20 + 1).astype(np.int32),
        "i_current_price": i_price,
        "i_wholesale_cost": np.round(i_price *
                                     rng.uniform(0.3, 0.9, n_item), 2),
        "i_manager_id": rng.integers(1, 101, n_item).astype(np.int32),
        "i_manufact_id": i_manufact_id,
        "i_manufact": _strs([f"manufact#{int(m)}"
                             for m in i_manufact_id]),
        "i_product_name": _strs([f"product-{int(i)}" for i in isk]),
        "i_color": _strs([_COLORS[int(i) % len(_COLORS)]
                          for i in isk]),
        "i_size": _strs([_SIZES[int(i) % len(_SIZES)] for i in isk]),
        "i_units": _strs([_UNITS[int(i) % len(_UNITS)]
                          for i in isk]),
    }
    cat.tables["item"] = _add(tables, data_dir, "item", item, 1)

    # ---- store ------------------------------------------------------------
    n_store = max(4, int(12 * max(sf, 0.1)))
    ssk = np.arange(n_store, dtype=np.int64) + 1
    _CITIES = ("Midway", "Fairview", "Oak Grove", "Five Points",
               "Pleasant Hill", "Centerville", "Riverside", "Salem")
    _COUNTIES = ("Williamson County", "Franklin Parish", "Walker County",
                 "Ziebach County", "Daviess County", "Barrow County")
    _STREET_TYPES = ("Street", "Ave", "Blvd", "Ln", "Court", "Way")
    store = {
        "s_store_sk": ssk,
        "s_store_id": _strs([f"S{i:04d}" for i in ssk]),
        "s_store_name": _strs([f"store-{int(i)}" for i in ssk]),
        "s_state": _strs([_STATES[int(i) % len(_STATES)] for i in ssk]),
        "s_city": _strs([_CITIES[int(i) % len(_CITIES)] for i in ssk]),
        "s_county": _strs([_COUNTIES[int(i) % len(_COUNTIES)]
                           for i in ssk]),
        "s_zip": _strs([f"{35000 + int(i) * 7 % 60000:05d}"
                        for i in ssk]),
        "s_company_id": np.ones(n_store, dtype=np.int32),
        "s_company_name": _strs(["Unknown"] * n_store),
        "s_market_id": (ssk % 10 + 1).astype(np.int32),
        "s_number_employees": rng.integers(200, 301,
                                           n_store).astype(np.int32),
        "s_street_number": _strs([str(100 + int(i)) for i in ssk]),
        "s_street_name": _strs([f"Main {int(i)}" for i in ssk]),
        "s_street_type": _strs(
            [_STREET_TYPES[int(i) % len(_STREET_TYPES)] for i in ssk]),
        "s_suite_number": _strs([f"Suite {int(i) * 10}" for i in ssk]),
        "s_gmt_offset": np.full(n_store, -5.0),
    }
    cat.tables["store"] = _add(tables, data_dir, "store", store, 1)

    # ---- customer + address ----------------------------------------------
    # demographics table sizes (defined here: customer FKs reference them)
    n_hd = 7200
    n_cd = 19600
    n_cust = max(500, int(20_000 * sf))
    csk = np.arange(n_cust, dtype=np.int64) + 1
    addr_sk = rng.integers(1, n_cust + 1, n_cust).astype(np.int64)
    _FIRST = ("James", "Mary", "John", "Linda", "Robert", "Susan",
              "Michael", "Karen", "David", "Lisa", "Anna", "Paul")
    _LAST = ("Smith", "Johnson", "Williams", "Brown", "Jones", "Davis",
             "Miller", "Wilson", "Moore", "Taylor", "Lopez", "Lee")
    _SALUT = ("Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir")
    customer = {
        "c_customer_sk": csk,
        "c_customer_id": _strs([f"C{i:09d}" for i in csk]),
        "c_current_addr_sk": addr_sk,
        "c_current_cdemo_sk": (csk % n_cd + 1).astype(np.int64),
        "c_current_hdemo_sk": (csk % n_hd + 1).astype(np.int64),
        "c_first_name": _strs([_FIRST[int(i) % len(_FIRST)]
                               for i in csk]),
        "c_last_name": _strs([_LAST[(int(i) // 3) % len(_LAST)]
                              for i in csk]),
        "c_salutation": _strs([_SALUT[int(i) % len(_SALUT)]
                               for i in csk]),
        "c_preferred_cust_flag": _strs(
            [_CHANNELS[int(i) % 2] for i in csk]),
        "c_birth_day": (csk % 28 + 1).astype(np.int32),
        "c_birth_month": (csk % 12 + 1).astype(np.int32),
        "c_birth_year": (1924 + csk % 69).astype(np.int32),
        "c_birth_country": _strs(
            [_COUNTRIES[int(i) % len(_COUNTRIES)] for i in csk]),
        "c_login": _strs([f"user{int(i)}" for i in csk]),
        "c_email_address": _strs(
            [f"user{int(i)}@example.com" for i in csk]),
        "c_first_sales_date_sk": sk[(csk * 13) % n_days],
        "c_first_shipto_date_sk": sk[(csk * 13 + 30) % n_days],
        "c_last_review_date_sk": sk[(csk * 17) % n_days],
    }
    cat.tables["customer"] = _add(tables, data_dir, "customer", customer, 2)
    ca = {
        "ca_address_sk": csk,
        "ca_state": _strs([_STATES[int(rng.integers(len(_STATES)))]
                           for _ in range(n_cust)]),
        "ca_country": _strs(["United States"] * n_cust),
        "ca_city": _strs([_CITIES[int(i) % len(_CITIES)]
                          for i in csk]),
        "ca_county": _strs([_COUNTIES[int(i) % len(_COUNTIES)]
                            for i in csk]),
        "ca_zip": _strs([f"{10000 + int(i) * 31 % 89999:05d}"
                         for i in csk]),
        "ca_street_number": _strs([str(1 + int(i) % 999)
                                   for i in csk]),
        "ca_street_name": _strs([f"Elm {int(i) % 40}" for i in csk]),
        "ca_street_type": _strs(
            [_STREET_TYPES[int(i) % len(_STREET_TYPES)] for i in csk]),
        "ca_suite_number": _strs([f"Suite {int(i) % 100}"
                                  for i in csk]),
        "ca_location_type": _strs(
            [("apartment", "condo", "single family")[int(i) % 3]
             for i in csk]),
        "ca_gmt_offset": rng.choice([-5.0, -6.0, -7.0, -8.0], n_cust),
    }
    cat.tables["customer_address"] = _add(
        tables, data_dir, "customer_address", ca, 2)

    # ---- warehouse / ship_mode / reason / call_center / web glue ---------
    n_wh = max(3, int(5 * max(sf, 0.1)))
    wsk = np.arange(n_wh, dtype=np.int64) + 1
    warehouse = {
        "w_warehouse_sk": wsk,
        "w_warehouse_name": _strs([f"Warehouse-{int(i)}" for i in wsk]),
        "w_warehouse_sq_ft": rng.integers(50_000, 1_000_000,
                                          n_wh).astype(np.int32),
        "w_state": _strs([_STATES[int(i) % len(_STATES)] for i in wsk]),
        "w_city": _strs([_CITIES[int(i) % len(_CITIES)] for i in wsk]),
        "w_county": _strs([_COUNTIES[int(i) % len(_COUNTIES)]
                           for i in wsk]),
        "w_country": _strs(["United States"] * n_wh),
    }
    cat.tables["warehouse"] = _add(tables, data_dir, "warehouse",
                                            warehouse, 1)

    _SM_TYPES = ("EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY")
    _SM_CARRIERS = ("UPS", "FEDEX", "AIRBORNE", "USPS", "DHL")
    smsk = np.arange(10, dtype=np.int64) + 1
    ship_mode = {
        "sm_ship_mode_sk": smsk,
        "sm_type": _strs([_SM_TYPES[int(i) % len(_SM_TYPES)]
                          for i in smsk]),
        "sm_carrier": _strs([_SM_CARRIERS[int(i) % len(_SM_CARRIERS)]
                             for i in smsk]),
    }
    cat.tables["ship_mode"] = _add(tables, data_dir, "ship_mode",
                                            ship_mode, 1)

    _REASONS = ("Package was damaged", "Stopped working", "Did not fit",
                "Not the product that was ordred", "Parts missing",
                "Does not work with a product that I have",
                "Gift exchange", "Did not like the color",
                "Did not like the model", "Found a better price")
    rsk = np.arange(len(_REASONS), dtype=np.int64) + 1
    reason = {
        "r_reason_sk": rsk,
        "r_reason_desc": _strs(list(_REASONS)),
    }
    cat.tables["reason"] = _add(tables, data_dir, "reason", reason, 1)

    n_cc = max(2, int(4 * max(sf, 0.1)))
    ccsk = np.arange(n_cc, dtype=np.int64) + 1
    call_center = {
        "cc_call_center_sk": ccsk,
        "cc_call_center_id": _strs([f"CC{i:06d}" for i in ccsk]),
        "cc_name": _strs([f"call-center-{int(i)}" for i in ccsk]),
        "cc_manager": _strs([f"Manager{int(i) % 7}" for i in ccsk]),
        "cc_county": _strs([_COUNTIES[int(i) % len(_COUNTIES)]
                            for i in ccsk]),
    }
    cat.tables["call_center"] = _add(tables, data_dir, "call_center",
                                              call_center, 1)

    n_web = max(2, int(4 * max(sf, 0.1)))
    websk = np.arange(n_web, dtype=np.int64) + 1
    web_site = {
        "web_site_sk": websk,
        "web_site_id": _strs([f"WEB{i:04d}" for i in websk]),
        "web_name": _strs([f"site-{int(i)}" for i in websk]),
        "web_company_name": _strs(
            [("pri", "ought", "able", "ese", "anti")[int(i) % 5]
             for i in websk]),
    }
    cat.tables["web_site"] = _add(tables, data_dir, "web_site",
                                           web_site, 1)

    n_wp = max(4, int(10 * max(sf, 0.1)))
    wpsk = np.arange(n_wp, dtype=np.int64) + 1
    web_page = {
        "wp_web_page_sk": wpsk,
        "wp_char_count": rng.integers(100, 8000, n_wp).astype(np.int32),
    }
    cat.tables["web_page"] = _add(tables, data_dir, "web_page",
                                           web_page, 1)

    n_cp = max(10, int(40 * max(sf, 0.1)))
    cpsk = np.arange(n_cp, dtype=np.int64) + 1
    catalog_page = {
        "cp_catalog_page_sk": cpsk,
        "cp_catalog_page_id": _strs([f"CP{i:06d}" for i in cpsk]),
    }
    cat.tables["catalog_page"] = _add(tables, data_dir, "catalog_page",
                                               catalog_page, 1)

    # ---- demographics ----------------------------------------------------
    n_ib = 20
    ibsk = np.arange(n_ib, dtype=np.int64) + 1
    income_band = {
        "ib_income_band_sk": ibsk,
        "ib_lower_bound": (ibsk * 10_000 - 10_000).astype(np.int32),
        "ib_upper_bound": (ibsk * 10_000).astype(np.int32),
    }
    cat.tables["income_band"] = _add(tables, data_dir, "income_band",
                                              income_band, 1)

    _BUY_POTENTIAL = (">10000", "5001-10000", "1001-5000", "501-1000",
                      "0-500", "Unknown")
    hdsk = np.arange(n_hd, dtype=np.int64) + 1
    hd = {
        "hd_demo_sk": hdsk,
        "hd_income_band_sk": (hdsk % n_ib + 1).astype(np.int64),
        "hd_buy_potential": _strs(
            [_BUY_POTENTIAL[int(i) % len(_BUY_POTENTIAL)] for i in hdsk]),
        "hd_dep_count": (hdsk % 10).astype(np.int32),
        "hd_vehicle_count": (hdsk % 5).astype(np.int32),
    }
    cat.tables["household_demographics"] = _add(
        tables, data_dir, "household_demographics", hd, 1)

    _GENDERS = ("M", "F")
    _MARITAL = ("S", "M", "D", "W", "U")
    _EDUCATION = ("Primary", "Secondary", "College", "2 yr Degree",
                  "4 yr Degree", "Advanced Degree", "Unknown")
    cdsk = np.arange(n_cd, dtype=np.int64) + 1
    cd = {
        "cd_demo_sk": cdsk,
        "cd_gender": _strs([_GENDERS[int(i) % 2] for i in cdsk]),
        "cd_marital_status": _strs(
            [_MARITAL[int(i) % len(_MARITAL)] for i in cdsk]),
        "cd_education_status": _strs(
            [_EDUCATION[int(i) % len(_EDUCATION)] for i in cdsk]),
        "cd_purchase_estimate": ((cdsk % 20 + 1) * 500).astype(np.int32),
        "cd_credit_rating": _strs(
            [("Good", "Low Risk", "High Risk", "Unknown")[int(i) % 4]
             for i in cdsk]),
        "cd_dep_count": (cdsk % 7).astype(np.int32),
        "cd_dep_employed_count": (cdsk % 5).astype(np.int32),
        "cd_dep_college_count": (cdsk % 4).astype(np.int32),
    }
    cat.tables["customer_demographics"] = _add(
        tables, data_dir, "customer_demographics", cd, 2)

    # ---- time_dim: per-minute granularity --------------------------------
    n_min = 24 * 60
    tsk = np.arange(n_min, dtype=np.int64)
    time_dim = {
        "t_time_sk": tsk,
        "t_time": (tsk * 60).astype(np.int32),
        "t_hour": (tsk // 60).astype(np.int32),
        "t_minute": (tsk % 60).astype(np.int32),
        "t_meal_time": _strs(
            [("breakfast" if 6 <= h < 9 else
              "lunch" if 11 <= h < 13 else
              "dinner" if 17 <= h < 20 else None)
             for h in (tsk // 60)]),
    }
    cat.tables["time_dim"] = _add(tables, data_dir, "time_dim",
                                           time_dim, 1)

    # ---- promotion --------------------------------------------------------
    n_promo = max(10, int(30 * max(sf, 0.1)))
    psk = np.arange(n_promo, dtype=np.int64) + 1
    promo = {
        "p_promo_sk": psk,
        "p_channel_email": _strs([_CHANNELS[int(i) % 2] for i in psk]),
        "p_channel_event": _strs([_CHANNELS[(int(i) // 2) % 2]
                                  for i in psk]),
        "p_channel_dmail": _strs([_CHANNELS[(int(i) // 3) % 2]
                                  for i in psk]),
        "p_channel_tv": _strs([_CHANNELS[(int(i) // 4) % 2]
                               for i in psk]),
    }
    cat.tables["promotion"] = _add(tables, data_dir, "promotion", promo, 1)

    # ---- fact tables ------------------------------------------------------
    def fact(n_rows: int, prefix: str, extra: Dict[str, np.ndarray],
             date_col: str, item_col: str, cust_col: str) -> Columns:
        qty = rng.integers(1, 100, n_rows).astype(np.int32)
        price = np.round(rng.uniform(1.0, 200.0, n_rows), 2)
        # sales_price <= list_price, the dsdgen discount invariant the
        # reference queries' avg-comparison predicates rely on
        list_price = np.round(price * rng.uniform(1.0, 1.5, n_rows), 2)
        wholesale = np.round(price * rng.uniform(0.3, 0.9, n_rows), 2)
        discount = np.round((list_price - price) * qty, 2)
        ext_sales = np.round(price * qty, 2)
        cols = {
            date_col: sk[rng.integers(0, n_days, n_rows)],
            item_col: isk[rng.integers(0, n_item, n_rows)],
            cust_col: csk[rng.integers(0, n_cust, n_rows)],
            f"{prefix}_quantity": qty,
            f"{prefix}_sales_price": price,
            f"{prefix}_list_price": list_price,
            f"{prefix}_wholesale_cost": wholesale,
            f"{prefix}_ext_sales_price": ext_sales,
            f"{prefix}_ext_list_price": np.round(list_price * qty, 2),
            f"{prefix}_ext_wholesale_cost": np.round(wholesale * qty, 2),
            f"{prefix}_ext_discount_amt": discount,
            f"{prefix}_coupon_amt": np.round(
                ext_sales * rng.choice([0.0, 0.0, 0.0, 0.1, 0.3],
                                       n_rows), 2),
            f"{prefix}_net_paid": np.round(
                ext_sales * rng.uniform(0.7, 1.0, n_rows), 2),
            f"{prefix}_net_profit": np.round(
                rng.normal(10, 40, n_rows), 2),
        }
        cols.update(extra)
        return cols

    n_ss = max(2_000, int(1_000_000 * sf))
    ss = fact(n_ss, "ss", {
        "ss_store_sk": ssk[rng.integers(0, n_store, n_ss)],
        "ss_promo_sk": psk[rng.integers(0, n_promo, n_ss)],
        "ss_ticket_number": np.arange(n_ss, dtype=np.int64) + 1,
        "ss_hdemo_sk": hdsk[rng.integers(0, n_hd, n_ss)],
        "ss_cdemo_sk": cdsk[rng.integers(0, n_cd, n_ss)],
        "ss_addr_sk": csk[rng.integers(0, n_cust, n_ss)],
        "ss_sold_time_sk": tsk[rng.integers(0, n_min, n_ss)],
        "ss_ext_tax": np.round(rng.uniform(0.0, 20.0, n_ss), 2),
    }, "ss_sold_date_sk", "ss_item_sk", "ss_customer_sk")
    cat.tables["store_sales"] = _add(
        tables, data_dir, "store_sales", ss, fact_chunks)

    # store_returns: a subset of tickets comes back
    n_sr = max(200, n_ss // 10)
    ridx = rng.choice(n_ss, n_sr, replace=False)
    sr = {
        "sr_returned_date_sk": sk[rng.integers(0, n_days, n_sr)],
        "sr_item_sk": ss["ss_item_sk"][ridx],
        "sr_customer_sk": ss["ss_customer_sk"][ridx],
        "sr_store_sk": ss["ss_store_sk"][ridx],
        "sr_ticket_number": ss["ss_ticket_number"][ridx],
        # referential: the returning customer's current demographics
        "sr_cdemo_sk": (ss["ss_customer_sk"][ridx] % n_cd
                        + 1).astype(np.int64),
        "sr_reason_sk": rsk[rng.integers(0, len(rsk), n_sr)],
        "sr_return_quantity": np.maximum(
            1, ss["ss_quantity"][ridx] //
            rng.integers(1, 4, n_sr)).astype(np.int32),
        "sr_return_amt": np.round(
            ss["ss_ext_sales_price"][ridx] *
            rng.uniform(0.1, 1.0, n_sr), 2),
        "sr_net_loss": np.round(rng.uniform(0.5, 300.0, n_sr), 2),
    }
    cat.tables["store_returns"] = _add(
        tables, data_dir, "store_returns", sr, max(1, fact_chunks // 2))

    n_cs = max(1_000, n_ss // 2)
    cs_sold = sk[rng.integers(0, n_days, n_cs)]
    cs = fact(n_cs, "cs", {
        # overrides fact()'s own draw (cols.update(extra) wins)
        "cs_sold_date_sk": cs_sold,
        # ~3 line items per order; ship a bounded number of days later
        "cs_order_number": np.arange(n_cs, dtype=np.int64) // 3 + 1,
        "cs_ship_date_sk": np.minimum(
            cs_sold + rng.integers(1, 121, n_cs), sk[-1]),
        "cs_warehouse_sk": wsk[rng.integers(0, n_wh, n_cs)],
        "cs_ship_mode_sk": smsk[rng.integers(0, len(smsk), n_cs)],
        "cs_call_center_sk": ccsk[rng.integers(0, n_cc, n_cs)],
        "cs_catalog_page_sk": cpsk[rng.integers(0, n_cp, n_cs)],
        "cs_promo_sk": psk[rng.integers(0, n_promo, n_cs)],
        "cs_sold_time_sk": tsk[rng.integers(0, n_min, n_cs)],
        "cs_bill_cdemo_sk": cdsk[rng.integers(0, n_cd, n_cs)],
        "cs_bill_hdemo_sk": hdsk[rng.integers(0, n_hd, n_cs)],
        "cs_bill_addr_sk": csk[rng.integers(0, n_cust, n_cs)],
        "cs_ship_customer_sk": csk[rng.integers(0, n_cust, n_cs)],
        "cs_ship_addr_sk": csk[rng.integers(0, n_cust, n_cs)],
        "cs_ship_cdemo_sk": cdsk[rng.integers(0, n_cd, n_cs)],
        "cs_ship_hdemo_sk": hdsk[rng.integers(0, n_hd, n_cs)],
        "cs_ext_ship_cost": np.round(rng.uniform(0.5, 80.0, n_cs), 2),
        "cs_ext_tax": np.round(rng.uniform(0.0, 20.0, n_cs), 2),
        "cs_net_paid_inc_tax": np.round(
            rng.uniform(1.0, 250.0, n_cs), 2),
    }, "cs_sold_date_sk", "cs_item_sk", "cs_bill_customer_sk")
    cat.tables["catalog_sales"] = _add(
        tables, data_dir, "catalog_sales", cs, max(1, fact_chunks // 2))

    # catalog_returns: a subset of catalog order lines comes back
    n_cr = max(100, n_cs // 10)
    cridx = rng.choice(n_cs, n_cr, replace=False)
    cr_amount = np.round(
        cs["cs_ext_sales_price"][cridx] *
        rng.uniform(0.1, 1.0, n_cr), 2)
    cr = {
        "cr_returned_date_sk": sk[rng.integers(0, n_days, n_cr)],
        "cr_item_sk": cs["cs_item_sk"][cridx],
        "cr_order_number": cs["cs_order_number"][cridx],
        "cr_returning_customer_sk":
            cs["cs_bill_customer_sk"][cridx],
        "cr_returning_addr_sk": csk[rng.integers(0, n_cust, n_cr)],
        "cr_call_center_sk": cs["cs_call_center_sk"][cridx],
        "cr_catalog_page_sk": cs["cs_catalog_page_sk"][cridx],
        "cr_reason_sk": rsk[rng.integers(0, len(rsk), n_cr)],
        "cr_return_quantity": np.maximum(
            1, cs["cs_quantity"][cridx] //
            rng.integers(1, 4, n_cr)).astype(np.int32),
        "cr_return_amount": cr_amount,
        "cr_return_amt_inc_tax": np.round(cr_amount * 1.08, 2),
        "cr_refunded_cash": np.round(
            cr_amount * rng.uniform(0.0, 1.0, n_cr), 2),
        "cr_reversed_charge": np.round(
            cr_amount * rng.uniform(0.0, 0.5, n_cr), 2),
        "cr_store_credit": np.round(
            cr_amount * rng.uniform(0.0, 0.5, n_cr), 2),
        "cr_net_loss": np.round(rng.uniform(0.5, 300.0, n_cr), 2),
    }
    cat.tables["catalog_returns"] = _add(
        tables, data_dir, "catalog_returns", cr, max(1, fact_chunks // 2))

    n_ws = max(1_000, n_ss // 4)
    ws_sold = sk[rng.integers(0, n_days, n_ws)]
    ws = fact(n_ws, "ws", {
        "ws_sold_date_sk": ws_sold,
        "ws_order_number": np.arange(n_ws, dtype=np.int64) // 3 + 1,
        "ws_ship_date_sk": np.minimum(
            ws_sold + rng.integers(1, 121, n_ws), sk[-1]),
        "ws_ship_addr_sk": csk[rng.integers(0, n_cust, n_ws)],
        "ws_ship_customer_sk": csk[rng.integers(0, n_cust, n_ws)],
        "ws_bill_addr_sk": csk[rng.integers(0, n_cust, n_ws)],
        "ws_web_site_sk": websk[rng.integers(0, n_web, n_ws)],
        "ws_warehouse_sk": wsk[rng.integers(0, n_wh, n_ws)],
        "ws_ship_mode_sk": smsk[rng.integers(0, len(smsk), n_ws)],
        "ws_web_page_sk": wpsk[rng.integers(0, n_wp, n_ws)],
        "ws_sold_time_sk": tsk[rng.integers(0, n_min, n_ws)],
        "ws_ship_hdemo_sk": hdsk[rng.integers(0, n_hd, n_ws)],
        "ws_promo_sk": psk[rng.integers(0, n_promo, n_ws)],
        "ws_ext_ship_cost": np.round(rng.uniform(0.5, 80.0, n_ws), 2),
    }, "ws_sold_date_sk", "ws_item_sk", "ws_bill_customer_sk")
    cat.tables["web_sales"] = _add(
        tables, data_dir, "web_sales", ws, max(1, fact_chunks // 2))

    # web_returns: a subset of web order lines comes back
    n_wr = max(100, n_ws // 8)
    wridx = rng.choice(n_ws, n_wr, replace=False)
    wr = {
        "wr_returned_date_sk": sk[rng.integers(0, n_days, n_wr)],
        "wr_item_sk": ws["ws_item_sk"][wridx],
        "wr_order_number": ws["ws_order_number"][wridx],
        "wr_returning_customer_sk":
            ws["ws_bill_customer_sk"][wridx],
        "wr_refunded_cdemo_sk": cdsk[rng.integers(0, n_cd, n_wr)],
        "wr_refunded_addr_sk": csk[rng.integers(0, n_cust, n_wr)],
        "wr_returning_cdemo_sk": cdsk[rng.integers(0, n_cd, n_wr)],
        "wr_returning_addr_sk": csk[rng.integers(0, n_cust, n_wr)],
        "wr_web_page_sk": ws["ws_web_page_sk"][wridx],
        "wr_reason_sk": rsk[rng.integers(0, len(rsk), n_wr)],
        "wr_return_quantity": np.maximum(
            1, ws["ws_quantity"][wridx] //
            rng.integers(1, 4, n_wr)).astype(np.int32),
        "wr_return_amt": np.round(
            ws["ws_ext_sales_price"][wridx] *
            rng.uniform(0.1, 1.0, n_wr), 2),
        "wr_fee": np.round(rng.uniform(0.5, 100.0, n_wr), 2),
        "wr_refunded_cash": np.round(rng.uniform(0.0, 200.0, n_wr), 2),
        "wr_net_loss": np.round(rng.uniform(0.5, 300.0, n_wr), 2),
    }
    cat.tables["web_returns"] = _add(
        tables, data_dir, "web_returns", wr, max(1, fact_chunks // 2))

    # inventory: weekly quantity-on-hand snapshots per item x warehouse
    inv_dates = sk[::7]
    n_inv = len(inv_dates) * n_item * n_wh
    inv = {
        "inv_date_sk": np.repeat(inv_dates, n_item * n_wh),
        "inv_item_sk": np.tile(np.repeat(isk, n_wh), len(inv_dates)),
        "inv_warehouse_sk": np.tile(wsk, len(inv_dates) * n_item),
        "inv_quantity_on_hand": rng.integers(
            0, 1000, n_inv).astype(np.int32),
    }
    cat.tables["inventory"] = _add(
        tables, data_dir, "inventory", inv, fact_chunks)

    return cat, tables


class TableEngine:
    """The foreign engine over generated tables: it serves a catalog's
    `FileSourceScanExec` and refuses any other node.

    Each file group of the scan becomes one split holding exactly the
    rows of its chunks (`chunk_bounds`), in chunk order, as items of at
    most `auron.batch.size` rows, with the columns the scan's output
    names.  As the JAX package's oracle, it applies no pushed filter: a
    `FilterExec` above the scan applies them.  A repeated scan (the same
    columns and file groups) gets the same `SourceTable` object, since
    the stage executor's source cache keys tables by identity.  `scans`
    counts the scans served.  A table's arrays are its columns' device
    layout: a decimal(p <= 18) column is its int64 unscaled values."""

    def __init__(self, catalog: Catalog, tables: Tables):
        self.catalog, self.tables = catalog, tables
        self._chunk = {path: (name, k)
                       for name, t in catalog.tables.items()
                       for k, path in enumerate(t.chunks)}
        self._made: Dict[Tuple, SourceTable] = {}
        self.scans = 0

    def execute(self, node: ForeignNode, child_tables) -> SourceTable:
        if node.op != "FileSourceScanExec":
            raise NotImplementedError(
                f"TableEngine serves FileSourceScanExec only, not "
                f"{node.op}")
        self.scans += 1
        groups = tuple(tuple(g) for g in node.attrs["file_groups"])
        key = (tuple(node.output.names()), groups)
        if key not in self._made:
            self._made[key] = self._scan(node.output, groups)
        return self._made[key]

    def _scan(self, output: Schema, groups) -> SourceTable:
        chunks = [self._chunk.get(p) for g in groups for p in g]
        if not chunks or None in chunks or \
                len({t for t, _ in chunks}) != 1:
            raise ValueError(f"file groups {groups} name no single table "
                             f"of the catalog")
        name = chunks[0][0]
        tdef = self.catalog.tables[name]
        arrays, validities = self.tables[name]
        idx = [tdef.schema.index_of(c) for c in output.names()]
        arrays = [arrays[i] for i in idx]
        validities = [validities[i] for i in idx]
        bounds = chunk_bounds(len(arrays[0]), len(tdef.chunks))
        batch = int(conf.get("auron.batch.size"))
        parts = []
        for g in groups:
            items = []
            for path in g:
                k = self._chunk[path][1]
                for s in range(bounds[k], bounds[k + 1], batch):
                    e = min(s + batch, bounds[k + 1])
                    items.append(([a[s:e] for a in arrays],
                                  [v[s:e] for v in validities]))
            parts.append(items)
        order = [k for _, k in chunks]
        if order == list(range(len(tdef.chunks))):
            whole = (arrays, validities)
        else:
            rows = np.concatenate([np.arange(bounds[k], bounds[k + 1])
                                   for k in order])
            whole = ([a[rows] for a in arrays], [v[rows] for v in validities])
        return SourceTable(parts, whole)
