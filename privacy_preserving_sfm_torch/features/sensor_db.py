"""Camera make/model -> sensor-width database for EXIF focal priors.

A copy of ``privacy_preserving_sfm_tpu/features/sensor_db.py`` (plain
Python, no arrays), so that the port imports nothing of that package.

Plays the role of the reference's vendor table + lookup
(``src/base/camera_database.cc:43-81`` QuerySensorWidth and
``src/util/camera_specs.cc`` InitializeCameraSpecs): a per-make list of
(model substring, sensor width mm) entries, queried with cleaned strings
(separators stripped, lower-cased, make removed from model), bidirectional
substring matching, exact-model short-circuit, and a unique-match
requirement for inexact hits.

The data here is authored from public sensor-format specifications (sensor
diagonal classes and per-family teardown figures), NOT copied from the
reference's table. Coverage is organized by model *family* where a family
shares one sensor format (e.g. every GoPro HERO and every Canon PowerShot
SX uses a 1/2.3" 6.17 mm sensor), with specific models listed where
formats changed across a family. Widths are the active-area width in mm of
the standard format classes:

    1/3.2" 4.54   1/3.0" 4.80   1/2.7" 5.37   1/2.5" 5.75   1/2.3" 6.17
    1/2.0" 6.40   1/1.8" 7.11   1/1.7" 7.60   1/1.6" 8.08   2/3"   8.80
    1/1.3" 9.80   1"     13.2   4/3"   17.3   APS-C  23.6 (Canon 22.3)
    APS-H  27.9   FF     36.0   44x33  43.8   54x40  53.7
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# Format-class widths (mm), used below so families read by format.
_13_2 = 4.54  # 1/3.2"
_13_0 = 4.80  # 1/3.0"
_12_7 = 5.37  # 1/2.7"
_12_5 = 5.75  # 1/2.5"
_12_3 = 6.17  # 1/2.3"
_12_0 = 6.40  # 1/2.0"
_11_8 = 7.11  # 1/1.8"
_11_7 = 7.60  # 1/1.7"
_11_6 = 8.08  # 1/1.6"
_23 = 8.80    # 2/3"
_11_3 = 9.80  # 1/1.3"
_1IN = 13.2   # 1"
_43 = 17.3    # four thirds
_APSC = 23.6  # APS-C (Sony/Nikon/Fuji/Pentax)
_APSC_C = 22.3  # APS-C (Canon)
_APSH = 27.9  # APS-H
_FF = 36.0    # full frame
_MF44 = 43.8  # 44x33 medium format
_MF54 = 53.7  # 54x40 medium format


def _fam(width: float, *models: str) -> Tuple[Tuple[str, float], ...]:
    return tuple((m, width) for m in models)


# make (cleaned) -> ((model substring (cleaned), width mm), ...).
# More specific entries must precede their family fallbacks because an
# exact model match short-circuits but inexact matches must be unique.
SENSOR_DB: Dict[str, Tuple[Tuple[str, float], ...]] = {
    "apple": (
        # iPhone main-camera modules by generation.
        _fam(4.54, "iphone", "iphone3g", "iphone3gs", "iphone4", "ipad",
             "ipodtouch") +
        _fam(4.57, "iphone4s") +
        _fam(4.54, "iphone5", "iphone5c") +
        _fam(4.89, "iphone5s", "iphone6", "iphone6plus", "iphonese") +
        _fam(4.80, "iphone6s", "iphone6splus", "iphone7", "iphone7plus",
             "iphone8", "iphone8plus", "iphonex") +
        _fam(5.60, "iphonexs", "iphonexsmax", "iphonexr", "iphone11",
             "iphone11pro", "iphone11promax", "iphonese2") +
        _fam(5.70, "iphone12", "iphone12mini", "iphone12pro",
             "iphone12promax") +
        _fam(7.00, "iphone13", "iphone13mini", "iphone14", "iphone14plus",
             "iphonese3") +
        _fam(9.50, "iphone13pro", "iphone13promax") +
        _fam(9.80, "iphone14pro", "iphone14promax", "iphone15pro",
             "iphone15promax", "iphone16pro", "iphone16promax") +
        _fam(7.60, "iphone15", "iphone15plus", "iphone16", "iphone16plus")
    ),
    "google": (
        _fam(5.60, "pixel", "pixelxl", "pixel2", "pixel2xl", "pixel3",
             "pixel3xl", "pixel3a", "pixel3axl", "pixel4", "pixel4xl",
             "pixel4a", "pixel5", "pixel5a") +
        _fam(9.80, "pixel6", "pixel6pro", "pixel7", "pixel7pro", "pixel8",
             "pixel8pro", "pixel9", "pixel9pro") +
        _fam(6.40, "pixel6a", "pixel7a", "pixel8a")
    ),
    "samsung": (
        # Galaxy phones (main modules), NX mirrorless, WB/ST/ES compacts.
        _fam(5.60, "galaxys4", "galaxys5", "galaxys6", "galaxys7",
             "galaxys8", "galaxys9", "galaxynote4", "galaxynote5",
             "galaxynote8", "galaxynote9", "smg920f", "smg930f",
             "smg950f", "smg960f") +
        _fam(6.40, "galaxys10", "galaxys20", "galaxys21", "galaxys22",
             "galaxys23", "galaxynote10", "galaxynote20", "smg973f",
             "smg980f", "smg991b") +
        _fam(9.50, "galaxys20ultra", "galaxys21ultra", "galaxys22ultra",
             "galaxys23ultra", "galaxys24ultra", "smg988b", "smg998b",
             "sms908b", "sms918b") +
        _fam(4.69, "galaxys2", "galaxys3", "galaxynote2", "galaxynote3",
             "gti9100", "gti9300") +
        _fam(_APSC, "nx10", "nx11", "nx100", "nx20", "nx200", "nx210",
             "nx300", "nx30", "nx500", "nx1000", "nx1100", "nx2000",
             "nx3000", "nx1") +
        _fam(_1IN, "nxmini") +
        _fam(_12_3, "wb150f", "wb250f", "wb350f", "wb800f", "wb2100",
             "st200f", "st150f", "es95", "es80", "dv150f", "mv800",
             "pl120", "pl210", "sh100", "st700", "st95") +
        _fam(_12_5, "s850", "s1050", "l730", "l830", "nv10")
    ),
    "huawei": (
        _fam(7.60, "p20pro", "clal29", "mate20pro", "lyal29") +
        _fam(7.30, "p30pro", "vogl29", "p40pro", "elsn29",
             "mate30pro", "mate40pro") +
        _fam(5.60, "p9", "p10", "p20", "p30", "mate9", "mate10", "mate20",
             "honor8", "honor9", "honor10", "eval09",
             "vtrl09")
    ),
    "xiaomi": (
        _fam(11.25, "mi11ultra", "m2102k1g", "13ultra", "14ultra") +
        _fam(6.40, "mi8", "mi9", "mi10", "mi11", "mi12", "redminote7",
             "redminote8", "redminote9", "redminote10", "pocof1",
             "pocox3", "mi9t", "mia1", "mia2", "mia3")
    ),
    "oneplus": (
        _fam(6.40, "one", "2", "3", "3t", "5", "5t", "6", "6t", "7",
             "7pro", "8", "8pro", "9", "9pro", "10pro", "11")
    ),
    "lg": (
        _fam(5.60, "g3", "g4", "g5", "g6", "g7", "g8", "v20", "v30",
             "v40", "v60", "nexus5", "nexus5x")
    ),
    "htc": (
        _fam(5.60, "one", "onem8", "onem9", "10", "u11", "u12")
    ),
    "motorola": (
        _fam(5.60, "motog", "motox", "motoz", "edge", "nexus6")
    ),
    "nokia": (
        _fam(10.67, "808pureview") +
        _fam(8.80, "lumia1020") +
        _fam(5.60, "lumia920", "lumia925", "lumia930", "lumia950", "7plus",
             "8", "9pureview", "3310")
    ),
    "canon": (
        # EOS full frame (the original 5D/6D are 35.8 mm; the later
        # 5D-family and 1-series bodies are 36.0 mm).
        _fam(35.8, "eos5d", "eos6d", "eos6dmarkii") +
        _fam(36.0, "eos5dmarkii", "eos5dmarkiii", "eos5dmarkiv",
             "eos5ds", "eos5dsr",
             "eos1dsmarkii", "eos1dsmarkiii", "eos1dx",
             "eos1dxmarkii", "eos1dxmarkiii", "eosr", "eosrp", "eosr5",
             "eosr6", "eosr6markii", "eosr8", "eosr3") +
        # EOS APS-H.
        _fam(_APSH, "eos1d", "eos1dmarkii", "eos1dmarkiin",
             "eos1dmarkiii", "eos1dmarkiv") +
        # EOS APS-C (22.3 mm class).
        _fam(_APSC_C, "eos10d", "eos20d", "eos30d", "eos40d", "eos50d",
             "eos60d", "eos70d", "eos77d", "eos80d", "eos90d", "eos7d",
             "eos7dmarkii", "eos100d", "eos200d", "eos250d", "eos300d",
             "eos350d", "eos400d", "eos450d", "eos500d", "eos550d",
             "eos600d", "eos650d", "eos700d", "eos750d", "eos760d",
             "eos800d", "eos850d", "eos1000d", "eos1100d", "eos1200d",
             "eos1300d", "eos2000d", "eos4000d", "eosm", "eosm2", "eosm3",
             "eosm5", "eosm6", "eosm10", "eosm50", "eosm100", "eosm200",
             "eosr7", "eosr10", "eosr50", "eosr100",
             "digitalrebel", "digitalrebelxt", "digitalrebelxti",
             "rebelxs", "rebelxsi", "rebelt1i", "rebelt2i", "rebelt3",
             "rebelt3i", "rebelt4i", "rebelt5", "rebelt5i", "rebelt6",
             "rebelt6i", "rebelt6s", "rebelt7", "rebelt7i", "rebelt8i",
             "rebelsl1", "rebelsl2", "rebelsl3", "kissx2", "kissx3",
             "kissx4", "kissx5", "kissx7", "kissx9") +
        # PowerShot G large-sensor compacts.
        _fam(_11_8, "powershotg1", "powershotg2", "powershotg3",
             "powershotg5", "powershotg6", "powershotg7") +
        _fam(_11_7, "powershotg9", "powershotg10", "powershotg11",
             "powershotg12", "powershotg15", "powershotg16",
             "powershots90", "powershots95", "powershots100",
             "powershots110", "powershots120") +
        _fam(18.7, "powershotg1x", "powershotg1xmarkii") +
        _fam(_APSC_C, "powershotg1xmarkiii") +
        _fam(_1IN, "powershotg3x", "powershotg5x", "powershotg5xmarkii",
             "powershotg7x", "powershotg7xmarkii", "powershotg7xmarkiii",
             "powershotg9x", "powershotg9xmarkii") +
        # PowerShot 1/2.3"-class families.
        _fam(_12_3, "powershotsx", "powershota", "powershotd",
             "powershotelph", "ixus", "ixy", "powershotsx60hs",
             "powershotsx70hs", "powershotsx740hs", "powershota590is",
             "powershota620", "powershota630", "powershota640",
             "powershota710is", "powershota720is", "powershota2300",
             "powershotelph100hs", "powershotelph300hs",
             "powershotd20", "powershotd30") +
        _fam(_12_5, "powershotsd", "powershotsd750", "powershotsd780is",
             "powershotsd800is", "powershotsd850is", "powershotsd870is",
             "powershotsd1000", "powershotsd1100is", "powershots2is",
             "powershots3is", "powershots5is", "powershota95",
             "powershota400", "powershota520", "powershota530",
             "powershota540", "powershota550", "powershota560",
             "powershota570is", "powershota610", "powershota700")
    ),
    "nikon": (
        # FX full frame.
        _fam(35.9, "d3", "d3s", "d3x", "d4", "d4s", "d5", "d6", "d600",
             "d610", "d700", "d750", "d780", "d800", "d800e", "d810",
             "d850", "df", "z5", "z6", "z6ii", "z7", "z7ii", "z8", "z9",
             "zf") +
        # DX APS-C.
        _fam(_APSC, "d40", "d40x", "d50", "d60", "d70", "d70s", "d80",
             "d90", "d100", "d200", "d300", "d300s", "d500", "d3000",
             "d3100", "d3200", "d3300", "d3400", "d3500", "d5000",
             "d5100", "d5200", "d5300", "d5500", "d5600", "d7000",
             "d7100", "d7200", "d7500", "d1", "d1x", "d2x", "d2xs",
             "d2h", "z50", "z30", "zfc", "coolpixa") +
        # Nikon 1 (CX).
        _fam(_1IN, "1j1", "1j2", "1j3", "1j4", "1j5", "1v1", "1v2", "1v3",
             "1s1", "1s2", "1aw1") +
        # Coolpix large-sensor / enthusiast.
        _fam(_11_7, "coolpixp7000", "coolpixp7100", "coolpixp7700",
             "coolpixp7800", "coolpixp330", "coolpixp340") +
        _fam(_23, "coolpix8400", "coolpix8700", "coolpix8800") +
        # Coolpix 1/2.3" families.
        _fam(_12_3, "coolpixb500", "coolpixb600", "coolpixb700",
             "coolpixl810", "coolpixl820", "coolpixl830", "coolpixl840",
             "coolpixp90", "coolpixp100", "coolpixp500", "coolpixp510",
             "coolpixp520", "coolpixp530", "coolpixp600", "coolpixp610",
             "coolpixp900", "coolpixp950", "coolpixp1000", "coolpixs9100",
             "coolpixs9300", "coolpixs9500", "coolpixs9900", "coolpixaw100",
             "coolpixaw110", "coolpixaw120", "coolpixaw130", "coolpixw300",
             "coolpixs2800", "coolpixs3300", "coolpixs3500", "coolpixs4300",
             "coolpixs6300", "coolpixs6800", "coolpixs7000") +
        _fam(_12_5, "coolpixl3", "coolpixl10", "coolpixl11", "coolpixl12",
             "coolpixl18", "coolpixl20", "coolpixs200", "coolpixs210",
             "coolpixs220", "coolpixs230", "coolpixs500", "coolpixs550",
             "coolpixs600", "coolpixp50", "coolpix2100", "coolpix3100",
             "coolpix4100", "coolpix5200", "coolpix7600")
    ),
    "sony": (
        # Full-frame Alpha / RX1.
        _fam(35.8, "ilce7", "ilce7m2", "ilce7m3", "ilce7m4", "ilce7r",
             "ilce7rm2", "ilce7rm3", "ilce7rm4", "ilce7rm5", "ilce7s",
             "ilce7sm2", "ilce7sm3", "ilce7c", "ilce9", "ilce9m2",
             "ilce1", "dscrx1", "dscrx1r", "dscrx1rm2", "ilceqx1") +
        _fam(35.9, "dslra850", "dslra900", "slta99") +
        # APS-C E-mount / A-mount / NEX.
        _fam(_APSC, "ilce3000", "ilce3500", "ilce5000", "ilce5100",
             "ilce6000", "ilce6100", "ilce6300", "ilce6400", "ilce6500",
             "ilce6600", "ilce6700", "nex3", "nex3n", "nexc3", "nexf3",
             "nex5", "nex5n", "nex5r", "nex5t", "nex6", "nex7",
             "slta33", "slta35", "slta37", "slta55", "slta57", "slta58",
             "slta65", "slta77", "dslra100", "dslra200", "dslra230",
             "dslra290", "dslra300", "dslra330", "dslra350", "dslra380",
             "dslra450", "dslra500", "dslra550", "dslra560", "dslra580",
             "dslra700", "zve10") +
        # 1" RX / ZV.
        _fam(_1IN, "dscrx100", "dscrx100m2", "dscrx100m3", "dscrx100m4",
             "dscrx100m5", "dscrx100m6", "dscrx100m7", "dscrx10",
             "dscrx10m2", "dscrx10m3", "dscrx10m4", "dscrx0", "zv1") +
        # Cyber-shot compacts.
        _fam(_12_3, "dsch10", "dsch20", "dsch50", "dsch55", "dsch70",
             "dsch90", "dschx1", "dschx5", "dschx7v", "dschx9v",
             "dschx10v", "dschx20v", "dschx30v", "dschx50v", "dschx60v",
             "dschx80", "dschx90v", "dschx99", "dschx100v", "dschx200v",
             "dschx300", "dschx350", "dschx400v", "dscw530", "dscw550",
             "dscw570", "dscw610", "dscw620", "dscw630", "dscw650",
             "dscw690", "dscw710", "dscw730", "dscw800", "dscw810",
             "dscw830", "dscwx7", "dscwx9", "dscwx80", "dscwx220",
             "dscwx350", "dscwx500", "dsctx10", "dsctx20", "dsctx30",
             "dsctx100v") +
        _fam(_12_5, "dscw5", "dscw7", "dscw30", "dscw35", "dscw50",
             "dscw55", "dscw70", "dscw80", "dscw90", "dscw100", "dscw110",
             "dscw120", "dscw130", "dscw150", "dscw170", "dscw200",
             "dscw210", "dscw215", "dscw220", "dscw230", "dscw270",
             "dscw290", "dscw300", "dscw310", "dscw320", "dscw350",
             "dscw380", "dscs600", "dscs650", "dscs700", "dscs730",
             "dscs750", "dscs780", "dscs800", "dscs930", "dscs950",
             "dscs980", "dsct7", "dsct9", "dsct10", "dsct20", "dsct30",
             "dsct50", "dsct70", "dsct90", "dsct100", "dscp100",
             "dscp150", "dscp200", "dscn1", "dscn2", "dsch2", "dsch5") +
        _fam(_11_8, "dscv1", "dscv3", "dscp8", "dscp10", "dscp12",
             "dscf77", "dscf88") +
        _fam(_23, "dscf707", "dscf717", "dscf828", "dscr1")
    ),
    "fujifilm": (
        # X-mount / X100 APS-C.
        _fam(_APSC, "x100", "x100s", "x100t", "x100f", "x100v", "x100vi",
             "xpro1", "xpro2", "xpro3", "xt1", "xt2", "xt3", "xt4", "xt5",
             "xt10", "xt20", "xt30", "xt100", "xt200", "xe1", "xe2",
             "xe2s", "xe3", "xe4", "xa1", "xa2", "xa3", "xa5", "xa7",
             "xm1", "xh1", "xh2", "xh2s", "xs10", "xs20", "xf10", "xm5") +
        _fam(_MF44, "gfx50s", "gfx50r", "gfx100", "gfx100s", "gfx100ii") +
        # X10/X20/X30 2/3", XF1.
        _fam(_23, "x10", "x20", "x30", "xf1", "xs1") +
        # FinePix families.
        _fam(_11_6, "finepixf200exr", "finepixf300exr", "finepixf550exr",
             "finepixf600exr", "finepixf770exr", "finepixf800exr",
             "finepixhs20exr", "finepixhs30exr", "finepixhs50exr",
             "finepixs200exr") +
        _fam(_11_7, "finepixf30", "finepixf31fd", "finepixf40fd",
             "finepixf45fd", "finepixf50fd", "finepixf60fd",
             "finepixf70exr", "finepixf80exr", "finepixf100fd",
             "finepixs100fs", "finepixe900") +
        _fam(_12_3, "finepixs1", "finepixs2950", "finepixs3200",
             "finepixs4000", "finepixs4200", "finepixs4500", "finepixs8200",
             "finepixs8600", "finepixs9400w", "finepixsl300", "finepixsl1000",
             "finepixhs25exr", "finepixhs35exr", "finepixxp60", "finepixxp70",
             "finepixxp80", "finepixxp120", "finepixxp130", "finepixxp140",
             "finepixt300", "finepixt400", "finepixjx370", "finepixjx500",
             "finepixjz250", "finepixav150", "finepixax350") +
        _fam(_12_5, "finepixa100", "finepixa150", "finepixa170",
             "finepixa200", "finepixa330", "finepixa345", "finepixa350",
             "finepixa500", "finepixa600", "finepixa800", "finepixa900",
             "finepixe500", "finepixe510", "finepixe550", "finepixz1",
             "finepixz2", "finepixz3", "finepixz5fd", "finepixz10fd",
             "finepixz20fd", "finepixz30", "finepixz33wp", "finepixz70",
             "finepixz90", "finepixj10", "finepixj12", "finepixj15fd",
             "finepixj20", "finepixj25", "finepixj26", "finepixj27",
             "finepixj28", "finepixj30", "finepixj32", "finepixj38",
             "finepixj110w", "finepixj150w", "finepixj210", "finepixj250",
             "finepixl55", "finepixs5700", "finepixs5800", "finepixs8000fd",
             "finepixs8100fd", "finepixs2000hd", "finepixs1500") +
        # Fuji DSLRs (Nikon-mount bodies, APS-C).
        _fam(23.0, "finepixs1pro", "finepixs2pro", "finepixs3pro",
             "finepixs5pro", "finepixispro")
    ),
    "olympus": (
        # Micro Four Thirds / Four Thirds.
        _fam(_43, "em1", "em1markii", "em1markiii", "em1x", "em5",
             "em5markii", "em5markiii", "em10", "em10markii",
             "em10markiii", "em10markiv", "om1", "om5", "epl1", "epl2",
             "epl3", "epl5", "epl6", "epl7", "epl8", "epl9", "epl10",
             "ep1", "ep2", "ep3", "ep5", "ep7", "epm1", "epm2", "e1",
             "e3", "e5", "e30", "e300", "e330", "e400", "e410", "e420",
             "e450", "e500", "e510", "e520", "e600", "e620", "penf",
             "aira01") +
        # Large-sensor compacts.
        _fam(_11_7, "xz1", "xz2", "xz10", "stylus1") +
        # Tough / Stylus / SZ / SP compacts.
        _fam(_12_3, "tg1", "tg2", "tg3", "tg4", "tg5", "tg6", "tg610",
             "tg620", "tg630", "tg810", "tg820", "tg830", "tg850",
             "tg860", "tg870", "sz10", "sz12", "sz14", "sz16", "sz20",
             "sz30mr", "sz31mr", "sh1", "sh2", "sh21", "sh25mr", "sh50",
             "sh60", "sp100ee", "sp320", "sp350", "sp500uz", "sp510uz",
             "sp550uz", "sp560uz", "sp565uz", "sp570uz", "sp590uz",
             "sp600uz", "sp610uz", "sp620uz", "sp720uz", "sp800uz",
             "sp810uz", "vr310", "vr320", "vr340", "vg160", "vh410",
             "u9000", "mju9000", "mju7000", "mju5000") +
        _fam(_12_5, "mju700", "mju710", "mju720sw", "mju725sw", "mju730",
             "mju740", "mju750", "mju760", "mju770sw", "mju780", "mju790sw",
             "mju795sw", "mju800", "mju810", "mju820", "mju830", "mju840",
             "mju850sw", "mju1000", "mju1010", "mju1020", "mju1030sw",
             "u700", "u710", "u720sw", "u750", "u760", "u770sw", "u790sw",
             "u800", "u810", "u820", "u830", "u840", "u1000", "u1010",
             "u1020", "u1030sw", "fe100", "fe110", "fe115", "fe120",
             "fe130", "fe140", "fe170", "fe190", "fe210", "fe230",
             "fe270", "fe280", "fe300", "fe310", "fe340", "fe350",
             "fe360", "fe370", "fe4000", "fe4010", "fe46", "fe45",
             "x560wp", "x785", "x790", "x875", "c60z", "c70z", "c5060wz",
             "c7070wz", "c8080wz", "d545z", "d630z")
    ),
    "panasonic": (
        # Micro Four Thirds.
        _fam(_43, "dmcg1", "dmcg2", "dmcg3", "dmcg5", "dmcg6", "dmcg7",
             "dmcg8", "dmcg80", "dmcg81", "dmcg85", "dcg9", "dcg90",
             "dcg95", "dcg99", "dcg100", "dmcgh1", "dmcgh2", "dmcgh3",
             "dmcgh4", "dcgh5", "dcgh5s", "dcgh6", "dmcgx1", "dmcgx7",
             "dmcgx8", "dmcgx80", "dmcgx85", "dcgx9", "dmcgf1", "dmcgf2",
             "dmcgf3", "dmcgf5", "dmcgf6", "dmcgf7", "dmcgf8", "dcgf9",
             "dcgf10", "dmcgm1", "dmcgm5", "dmclx100", "dclx100m2") +
        # Full frame S series.
        _fam(_FF, "dcs1", "dcs1r", "dcs1h", "dcs5", "dcs5m2") +
        # 1" compacts / bridges.
        _fam(_1IN, "dmcfz1000", "dcfz1000m2", "dmcfz2000", "dmcfz2500",
             "dmclx10", "dmclx15", "dmczs100", "dmctz100", "dmczs200",
             "dmctz200", "dmccm1") +
        # Enthusiast small-sensor LX.
        _fam(_11_7, "dmclx3", "dmclx5", "dmclx7") +
        _fam(_11_8, "dmclx1", "dmclx2", "dmclc1") +
        # TZ/ZS, FZ, FS/FT/FH/SZ/TS compacts (1/2.3").
        _fam(_12_3, "dmctz1", "dmctz3", "dmctz5", "dmctz7", "dmctz8",
             "dmctz10", "dmctz18", "dmctz20", "dmctz25", "dmctz30",
             "dmctz35", "dmctz40", "dmctz55", "dmctz57", "dmctz60",
             "dmctz70", "dmctz80", "dmctz90", "dctz95", "dmczs1",
             "dmczs3", "dmczs5", "dmczs7", "dmczs8", "dmczs10", "dmczs15",
             "dmczs19", "dmczs20", "dmczs25", "dmczs30", "dmczs35",
             "dmczs40", "dmczs45", "dmczs50", "dmczs60", "dczs70",
             "dmcfz5", "dmcfz7", "dmcfz8", "dmcfz18", "dmcfz28",
             "dmcfz35", "dmcfz38", "dmcfz40", "dmcfz45", "dmcfz47",
             "dmcfz48", "dmcfz60", "dmcfz70", "dmcfz72", "dmcfz80",
             "dcfz80", "dcfz82", "dmcft1", "dmcft2", "dmcft3", "dmcft4",
             "dmcft5", "dmcts1", "dmcts2", "dmcts3", "dmcts4", "dmcts5",
             "dcts7", "dcft7", "dmcfh2", "dmcfh5", "dmcfh20", "dmcfh25",
             "dmcfs3", "dmcfs5", "dmcfs6", "dmcfs7", "dmcfs10", "dmcfs12",
             "dmcfs15", "dmcfs16", "dmcfs25", "dmcfs30", "dmcfs33",
             "dmcfs42", "dmcfs62", "dmcsz1", "dmcsz3", "dmcsz5", "dmcsz7",
             "dmcsz8", "dmcsz10", "dmcf5", "dmcxs1", "dmcls5", "dmc3d1") +
        _fam(_12_5, "dmcfx01", "dmcfx07", "dmcfx3", "dmcfx8", "dmcfx9",
             "dmcfx10", "dmcfx12", "dmcfx30", "dmcfx33", "dmcfx35",
             "dmcfx37", "dmcfx40", "dmcfx50", "dmcfx55", "dmcfx60",
             "dmcfx65", "dmcfx66", "dmcfx68", "dmcfx70", "dmcfx75",
             "dmcfx77", "dmcfx78", "dmcfx80", "dmcfx90", "dmcfx100",
             "dmcfx150", "dmcfx500", "dmcfx550", "dmcfx580", "dmcls2",
             "dmcls3", "dmcls60", "dmcls70", "dmcls75", "dmcls80",
             "dmcls85", "dmclz2", "dmclz3", "dmclz5", "dmclz6", "dmclz7",
             "dmclz8", "dmclz10", "dmclz20", "dmcfz2", "dmcfz3", "dmcfz4",
             "dmcfz10", "dmcfz15", "dmcfz20", "dmcfz30", "dmcfz50")
    ),
    "pentax": (
        _fam(35.9, "k1", "k1markii") +
        _fam(_APSC, "k3", "k3ii", "k3markiii", "k5", "k5ii", "k5iis",
             "k7", "k10d", "k20d", "k30", "k50", "k70", "k100d", "k110d",
             "k200d", "k500", "kx", "kr", "km", "ks1", "ks2", "kp",
             "istd", "istds", "istdl", "istds2",
             "istdl2") +
        _fam(_MF44, "645d", "645z") +
        _fam(7.44, "q", "q7", "q10", "qs1", "mx1") +
        _fam(_12_3, "optiowg1", "optiowg2", "wg3", "wg10", "optiorz10",
             "optiorz18", "x5", "optiovs20") +
        _fam(_12_5, "optioa10", "optioa20", "optioa30", "optioa40",
             "optioe10", "optioe20", "optioe30", "optioe50", "optiom10",
             "optiom20", "optiom30", "optiom50", "optios", "optios4",
             "optios4i", "optios5i", "optios5n", "optios6", "optios7",
             "optios10", "optios12", "optiot10", "optiot20", "optiot30",
             "optiov10", "optiow10", "optiow20", "optiow30", "optiow60",
             "optiow80", "optiow90", "optiowp", "optiowpi", "optiop70",
             "optiop80", "optioh90", "optioi10", "optiol30", "optiol40",
             "optio330", "optio430", "optio550", "optio555", "optio750z")
    ),
    "ricoh": (
        _fam(_APSC, "gr", "grii", "griii", "griiix", "gxra12") +
        _fam(_11_7, "grdigitaliv", "gxrp10") +
        _fam(_11_8, "grdigital", "grdigitalii", "grdigitaliii", "gx100",
             "gx200") +
        _fam(_12_3, "wg4", "wg5gps", "wg6", "wg30", "wg50", "g900",
             "pentaxwg", "cx1", "cx2", "cx3", "cx4", "cx5", "cx6") +
        _fam(_12_5, "caplior1", "caplior2", "caplior3", "caplior4",
             "caplior5", "caplior6", "caplior7", "capliorr30", "capliogx",
             "capliogx8", "caplio500g", "r8", "r10", "rz10")
    ),
    "casio": (
        _fam(_11_7, "ex10", "ex100", "exzr4000") +
        _fam(_11_8, "exf1", "exp505", "exp600", "exp700") +
        _fam(_12_3, "exzr100", "exzr200", "exzr300", "exzr400", "exzr700",
             "exzr800", "exzr1000", "exzr1100", "exfc100", "exfc150",
             "exfh20", "exfh100", "exh10", "exh15", "exh20g", "exh30",
             "exh50", "ex10hs") +
        _fam(_12_5, "exz3", "exz4", "exz5", "exz6", "exz7", "exz8",
             "exz9", "exz10", "exz11", "exz12", "exz15", "exz19", "exz20",
             "exz25", "exz29", "exz30", "exz33", "exz35", "exz40",
             "exz50", "exz55", "exz57", "exz60", "exz65", "exz70",
             "exz75", "exz77", "exz80", "exz85", "exz90", "exz100",
             "exz110", "exz120", "exz150", "exz200", "exz250", "exz270",
             "exz280", "exz300", "exz400", "exz450", "exz500", "exz550",
             "exz600", "exz700", "exz750", "exz800", "exz850", "exz1000",
             "exz1050", "exz1080", "exz1200", "exs5", "exs6", "exs7",
             "exs8", "exs10", "exs12", "exs100", "exs500", "exs600",
             "exs770", "exs880", "exm1", "exm2", "exm20", "exn1", "exn5",
             "exn10", "exn50", "qvr40", "qvr51", "qvr61", "qvr62")
    ),
    "kodak": (
        _fam(_12_3, "easysharez950", "easysharez980", "easysharez981",
             "easysharez990", "easysharez5010", "easysharez5120",
             "easysharemax", "pixproaz251",
             "pixproaz361", "pixproaz401", "pixproaz421", "pixproaz501",
             "pixproaz521", "pixprofz151", "pixprofz201") +
        _fam(_12_5, "easysharec140", "easysharec143", "easysharec160",
             "easysharec180", "easysharec182", "easysharec190",
             "easysharec195", "easysharec300", "easysharec310",
             "easysharec315", "easysharec330", "easysharec340",
             "easysharec360", "easysharec433", "easysharec503",
             "easysharec530", "easysharec533", "easysharec610",
             "easysharec613", "easysharec623", "easysharec643",
             "easysharec653", "easysharec663", "easysharec703",
             "easysharec713", "easysharec743", "easysharec813",
             "easyshare875", "easysharecd33",
             "easysharecd43", "easysharecx7300", "easysharecx7330",
             "easysharecx7430", "easysharecx7525", "easysharecx7530",
             "easysharedx3900", "easysharedx4530", "easysharedx6340",
             "easysharedx6490", "easysharedx7440", "easysharedx7590",
             "easysharem320", "easysharem340", "easysharem341",
             "easysharem380", "easysharem381", "easysharem420",
             "easysharem522", "easysharem530", "easysharem531",
             "easysharem550", "easysharem552", "easysharem575",
             "easysharem580", "easysharem583", "easysharem590",
             "easysharem753", "easysharem763", "easysharem853",
             "easysharem863", "easysharem873", "easysharem883",
             "easysharem893is", "easysharemd30", "easysharemd41",
             "easysharemd81", "easysharemini", "easysharesport",
             "easysharetouch", "easysharev550", "easysharev570",
             "easysharev603", "easysharev610", "easysharev705",
             "easysharev803", "easysharev1003", "easysharez700",
             "easysharez710", "easysharez712is", "easysharez730",
             "easysharez740", "easysharez760", "easysharez812is",
             "easysharez885", "easysharez915", "easysharez1012is",
             "easysharez1015is", "easysharez1085is", "easysharez1275",
             "easysharez1285", "easysharez1485is", "easysharez8612is",
             "z1012is", "z990", "c913", "c1013", "m1063", "m1073is",
             "m1093is")
    ),
    "leica": (
        _fam(35.8, "m9", "m9p", "mmonochrom", "m240", "m10", "m10p",
             "m10r", "m11", "q", "q2", "q3", "sl", "sl2", "sl2s") +
        _fam(27.0, "m8") +
        _fam(_APSC, "x1", "x2", "xvario", "tl", "tl2", "cl", "t701") +
        _fam(_43, "dluxtyp109", "dlux7") +
        _fam(_11_7, "dlux4", "dlux5", "dlux6") +
        _fam(_11_8, "dlux2", "dlux3") +
        _fam(_1IN, "vluxtyp114", "vlux5", "cluxtyp112") +
        _fam(_12_3, "vlux2", "vlux3", "vlux30", "vlux40")
    ),
    "sigma": (
        _fam(20.7, "dp1", "dp1s", "dp1x", "dp2", "dp2s", "dp2x", "sd9",
             "sd10", "sd14", "sd15", "sd1", "sd1merrill", "dp1merrill",
             "dp2merrill", "dp3merrill") +
        _fam(_APSC, "dp1quattro", "dp2quattro", "dp3quattro", "dp0quattro",
             "sdquattro") +
        _fam(26.6, "sdquattroh") +
        _fam(_FF, "fp", "fpl")
    ),
    "minolta": (
        _fam(_APSC, "dynax7d", "dynax5d", "maxxum7d", "maxxum5d",
             "alpha7digital") +
        _fam(_23, "dimage7", "dimage7i", "dimage7hi", "dimagea1",
             "dimagea2", "dimagea200") +
        _fam(_11_8, "dimagef100", "dimagef200", "dimagef300", "dimages404",
             "dimages414", "dimages304", "dimagex", "dimagexi") +
        _fam(_12_5, "dimagez1", "dimagez2", "dimagez3", "dimagez5",
             "dimagez6", "dimagez10", "dimagez20", "dimagee323",
             "dimagee500", "dimagex1", "dimagex20", "dimagex21",
             "dimagex31", "dimagex50", "dimagex60", "dimagexg", "dimagext",
             "dimagextbiz", "dimageg400", "dimageg500",
             "dimageg530", "dimageg600")
    ),
    "konicaminolta": (
        _fam(_APSC, "dynax7d", "dynax5d", "maxxum7d", "maxxum5d") +
        _fam(_23, "dimagea2", "dimagea200") +
        _fam(_12_5, "dimagez3", "dimagez5", "dimagez6", "dimagex1",
             "dimagex50", "dimagex60", "dimageg530", "dimageg600",
             "dimagee500")
    ),
    "gopro": (
        _fam(_12_3, "hero", "hero2", "hero3", "hero3+", "hero4", "hero5",
             "hero6", "hero7", "hero8", "hero9", "hero10", "hero11",
             "hero12", "herosession", "fusion", "max")
    ),
    "dji": (
        # Drone modules by FC code: Phantom 3/4 std (1/2.3"), P4P (1"),
        # Mavic (1/2.3"), Mavic 2 Pro / Air 2s (1"), Mini (1/2.3").
        _fam(_12_3, "fc200", "fc220", "fc300c", "fc300s", "fc300x",
             "fc330", "fc350", "fc1102", "fc2103", "fc2204", "fc7203",
             "fc7303", "mavicair", "mavicmini", "minise", "spark",
             "osmoaction", "osmopocket") +
        _fam(_1IN, "fc6310", "fc6310s", "fc6360", "l1d20c", "fc3411",
             "fc3582", "zenmusex4s", "zenmusex5r") +
        _fam(_43, "zenmusex5", "zenmusex5s", "mavic3") +
        _fam(_FF, "zenmusep1")
    ),
    "parrot": (
        _fam(_12_3, "anafi", "bebop", "bebop2", "sequoia")
    ),
    "hasselblad": (
        _fam(_MF44, "x1d", "x1dii50c", "x2d100c", "cfv50", "h5d50c",
             "h6d50c") +
        _fam(_MF54, "h4d60", "h5d60", "h6d100c") +
        _fam(_1IN, "l1d20c", "l2d20c")
    ),
    "phaseone": (
        _fam(_MF54, "iq180", "iq260", "iq280", "iq3100mp", "iq4150mp",
             "p65+", "xf") +
        _fam(_MF44, "p40+", "p45+", "iq140", "iq150")
    ),
    "vivo": _fam(6.40, "x60pro", "x70pro", "x80pro", "x90pro", "nex3"),
    "oppo": _fam(6.40, "findx2pro", "findx3pro", "findx5pro", "reno"),
    "realme": _fam(6.40, "gt", "gt2pro", "x50pro"),
    "asus": (
        _fam(6.40, "zenfone6", "zenfone7", "zenfone8", "rogphone") +
        _fam(_12_3, "zenfone2", "zenfone3", "zenfone4", "zenfone5")
    ),
    "lenovo": _fam(5.60, "k900", "vibez2pro", "zuk"),
    "zte": _fam(5.60, "axon7", "axon10pro", "nubia"),
    "blackberry": _fam(5.60, "keyone", "priv", "z10", "z30"),
    "essential": _fam(5.60, "ph1"),
    "fairphone": _fam(6.40, "fp3", "fp4", "fp5"),
}

# Flattened entry count, exported so coverage tests can assert breadth.
NUM_ENTRIES = sum(len(v) for v in SENSOR_DB.values())


def _clean(s: str) -> str:
    return s.replace(" ", "").replace("-", "").lower()


def query_sensor_width(make: str, model: str) -> Optional[float]:
    """Sensor width lookup with the reference's matching semantics.

    Based on ``CameraDatabase::QuerySensorWidth``
    (``src/base/camera_database.cc:43-81``): clean
    separators + case, strip the make from the model, bidirectional
    substring match on make and model, exact-model short-circuit.

    One deliberate improvement over the reference: for inexact hits the
    reference requires a globally unique match, which rejects every model
    whose name extends a listed family prefix ("eos5d" vs
    "eos5dmarkiii" both match "eos 5d mark iii n").  Here the LONGEST
    matching entry wins; ambiguity only rejects when two maximal-length
    matches disagree on the width.
    """
    cleaned_make = _clean(make)
    cleaned_model = _clean(model).replace(cleaned_make, "")
    if not cleaned_make or not cleaned_model:
        return None

    best_len = -1
    widths = set()
    for db_make, entries in SENSOR_DB.items():
        if db_make in cleaned_make or cleaned_make in db_make:
            for db_model, width in entries:
                if db_model in cleaned_model or cleaned_model in db_model:
                    if cleaned_model == db_model:
                        return width
                    n = len(db_model)
                    if n > best_len:
                        best_len, widths = n, {width}
                    elif n == best_len:
                        widths.add(width)
    return widths.pop() if len(widths) == 1 else None
