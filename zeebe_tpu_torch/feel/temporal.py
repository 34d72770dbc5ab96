"""FEEL temporal types: date, time, date-and-time, and the two durations.

Reference: expression-language/src/main/java/io/camunda/zeebe/el/impl/
FeelExpressionLanguage.java:22-36 wires the camunda FEEL Scala engine, whose
temporal semantics follow the DMN FEEL spec: four temporal value types
(``date``, ``time``, ``date and time``) plus two duration types
(days-and-time ``duration`` and ``years and months duration``), ISO-8601
literal syntax behind ``@"..."``, calendar arithmetic, and component
properties. This module implements that surface from scratch on top of
Python ``datetime``/``zoneinfo``.

Values serialize back to ISO-8601 strings at the variable-store boundary
(the reference's MessagePackValueMapper.scala writes FEEL temporals as
msgpack strings), so device/host variable documents never carry rich
objects.

FEEL-lite extension kept for engine ergonomics: plain numbers interoperate
with temporals as *milliseconds* (``now() + 1000``), matching the engine's
epoch-millis clock plumbing.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re
from typing import Any

try:  # zoneinfo is stdlib ≥3.9; @"…@Zone" literals need it
    import zoneinfo as _zoneinfo
except ImportError:  # pragma: no cover
    _zoneinfo = None


class TemporalParseError(ValueError):
    pass


_UTC = _dt.timezone.utc

# ---------------------------------------------------------------------------
# Durations


@dataclasses.dataclass(frozen=True, slots=True, order=True)
class Duration:
    """Days-and-time duration: a fixed span in milliseconds (``P1DT2H``)."""

    millis: int

    # -- components (FEEL properties: days/hours/minutes/seconds) -----------
    @property
    def days(self) -> int:
        return int(abs(self.millis) // 86_400_000) * (1 if self.millis >= 0 else -1)

    @property
    def hours(self) -> int:
        return int((abs(self.millis) % 86_400_000) // 3_600_000) * (1 if self.millis >= 0 else -1)

    @property
    def minutes(self) -> int:
        return int((abs(self.millis) % 3_600_000) // 60_000) * (1 if self.millis >= 0 else -1)

    @property
    def seconds(self) -> float:
        s = (abs(self.millis) % 60_000) / 1000.0
        return s if self.millis >= 0 else -s

    def __str__(self) -> str:
        ms = abs(self.millis)
        sign = "-" if self.millis < 0 else ""
        days, ms = divmod(ms, 86_400_000)
        hours, ms = divmod(ms, 3_600_000)
        minutes, ms = divmod(ms, 60_000)
        seconds = ms / 1000.0
        out = f"{sign}P"
        if days:
            out += f"{days}D"
        time_part = ""
        if hours:
            time_part += f"{hours}H"
        if minutes:
            time_part += f"{minutes}M"
        if seconds:
            text = f"{seconds:.3f}".rstrip("0").rstrip(".")
            time_part += f"{text}S"
        if time_part:
            out += "T" + time_part
        if out in ("P", "-P"):
            out = sign + "PT0S"
        return out

    def __neg__(self) -> "Duration":
        return Duration(-self.millis)

    def __abs__(self) -> "Duration":
        return Duration(abs(self.millis))


@dataclasses.dataclass(frozen=True, slots=True, order=True)
class YearMonthDuration:
    """Years-and-months duration: a calendar span in months (``P1Y2M``)."""

    months: int

    @property
    def years(self) -> int:
        return int(abs(self.months) // 12) * (1 if self.months >= 0 else -1)

    # FEEL property is "months" = remainder after years; expose via accessor
    # name "months_part" internally, property lookup maps it.
    @property
    def months_part(self) -> int:
        return int(abs(self.months) % 12) * (1 if self.months >= 0 else -1)

    def __str__(self) -> str:
        m = abs(self.months)
        sign = "-" if self.months < 0 else ""
        years, months = divmod(m, 12)
        out = f"{sign}P"
        if years:
            out += f"{years}Y"
        if months or not years:
            out += f"{months}M"
        return out

    def __neg__(self) -> "YearMonthDuration":
        return YearMonthDuration(-self.months)

    def __abs__(self) -> "YearMonthDuration":
        return YearMonthDuration(abs(self.months))


# ---------------------------------------------------------------------------
# Date / time / date-and-time


def _fmt_offset(offset: _dt.timedelta | None) -> str:
    if offset is None:
        return ""
    total = int(offset.total_seconds())
    if total == 0:
        return "Z"
    sign = "+" if total >= 0 else "-"
    total = abs(total)
    hh, rem = divmod(total, 3600)
    mm = rem // 60
    return f"{sign}{hh:02d}:{mm:02d}"


@dataclasses.dataclass(frozen=True, slots=True, order=True)
class FeelDate:
    """Calendar date (``date("2026-07-31")``)."""

    d: _dt.date

    @property
    def year(self) -> int:
        return self.d.year

    @property
    def month(self) -> int:
        return self.d.month

    @property
    def day(self) -> int:
        return self.d.day

    @property
    def weekday(self) -> int:
        return self.d.isoweekday()

    def __str__(self) -> str:
        return self.d.isoformat()


@dataclasses.dataclass(frozen=True, slots=True, order=True)
class FeelTime:
    """Wall-clock time, optionally zoned (``time("14:30:00+02:00")``)."""

    t: _dt.time  # tzinfo carries the offset when zoned
    # display-only zone name: equal instants must compare equal regardless
    # of whether the zone came from an offset or an @Zone name
    zone: str | None = dataclasses.field(default=None, compare=False)

    @property
    def hour(self) -> int:
        return self.t.hour

    @property
    def minute(self) -> int:
        return self.t.minute

    @property
    def second(self) -> int:
        return self.t.second

    @property
    def time_offset(self) -> Duration | None:
        off = self.t.utcoffset()
        return None if off is None else Duration(int(off.total_seconds() * 1000))

    def __str__(self) -> str:
        base = self.t.replace(tzinfo=None).isoformat()
        if self.t.microsecond == 0:
            base = base[:8]
        if self.zone:
            return f"{base}@{self.zone}"
        return base + _fmt_offset(self.t.utcoffset())


@dataclasses.dataclass(frozen=True, slots=True, order=True)
class FeelDateTime:
    """Date-and-time, optionally zoned (``date and time("…T…Z")``)."""

    dt: _dt.datetime
    zone: str | None = dataclasses.field(default=None, compare=False)

    @classmethod
    def from_epoch_millis(cls, millis: int) -> "FeelDateTime":
        return cls(_dt.datetime.fromtimestamp(millis / 1000.0, tz=_UTC))

    @property
    def epoch_millis(self) -> int:
        if self.dt.tzinfo is None:
            # local (unzoned) datetimes anchor to UTC for engine arithmetic
            return int(self.dt.replace(tzinfo=_UTC).timestamp() * 1000)
        return int(self.dt.timestamp() * 1000)

    @property
    def year(self) -> int:
        return self.dt.year

    @property
    def month(self) -> int:
        return self.dt.month

    @property
    def day(self) -> int:
        return self.dt.day

    @property
    def weekday(self) -> int:
        return self.dt.isoweekday()

    @property
    def hour(self) -> int:
        return self.dt.hour

    @property
    def minute(self) -> int:
        return self.dt.minute

    @property
    def second(self) -> int:
        return self.dt.second

    @property
    def time_offset(self) -> Duration | None:
        off = self.dt.utcoffset()
        return None if off is None else Duration(int(off.total_seconds() * 1000))

    def date(self) -> FeelDate:
        return FeelDate(self.dt.date())

    def time(self) -> FeelTime:
        return FeelTime(self.dt.timetz(), zone=self.zone)

    def __str__(self) -> str:
        base = self.dt.replace(tzinfo=None).isoformat()
        if self.dt.microsecond == 0:
            base = base[:19]  # seconds always printed (reference format)
        if self.zone:
            return f"{base}@{self.zone}"
        return base + _fmt_offset(self.dt.utcoffset())


# ---------------------------------------------------------------------------
# Parsing

_DATE_RE = re.compile(r"^(\d{4})-(\d{2})-(\d{2})$")
_TIME_RE = re.compile(
    r"^(\d{2}):(\d{2})(?::(\d{2})(?:\.(\d{1,9}))?)?"
    r"(Z|[+-]\d{2}:\d{2}|@[A-Za-z_][A-Za-z0-9_/+\-]*)?$"
)
_DT_DURATION_RE = re.compile(
    r"^(?P<sign>-)?P(?:(?P<days>\d+(?:\.\d+)?)D)?"
    r"(?:T(?:(?P<hours>\d+(?:\.\d+)?)H)?(?:(?P<minutes>\d+(?:\.\d+)?)M)?"
    r"(?:(?P<seconds>\d+(?:\.\d+)?)S)?)?$"
)
_YM_DURATION_RE = re.compile(r"^(?P<sign>-)?P(?:(?P<years>\d+)Y)?(?:(?P<months>\d+)M)?$")


def _tz_from_suffix(suffix: str) -> tuple[_dt.tzinfo | None, str | None]:
    """'Z' / '+02:00' / '@Europe/Berlin' → (tzinfo, zone-name-or-None)."""
    if not suffix:
        return None, None
    if suffix == "Z":
        return _UTC, None
    if suffix.startswith("@"):
        name = suffix[1:]
        if _zoneinfo is None:
            raise TemporalParseError(f"zone literals unsupported: {suffix!r}")
        try:
            return _zoneinfo.ZoneInfo(name), name
        except Exception as exc:
            raise TemporalParseError(f"unknown zone {name!r}") from exc
    sign = 1 if suffix[0] == "+" else -1
    hh, mm = int(suffix[1:3]), int(suffix[4:6])
    return _dt.timezone(sign * _dt.timedelta(hours=hh, minutes=mm)), None


def parse_date(text: str) -> FeelDate:
    m = _DATE_RE.match(text.strip())
    if not m:
        raise TemporalParseError(f"invalid date: {text!r}")
    try:
        return FeelDate(_dt.date(int(m.group(1)), int(m.group(2)), int(m.group(3))))
    except ValueError as exc:
        raise TemporalParseError(f"invalid date: {text!r}") from exc


def parse_time(text: str) -> FeelTime:
    m = _TIME_RE.match(text.strip())
    if not m:
        raise TemporalParseError(f"invalid time: {text!r}")
    hh, mm = int(m.group(1)), int(m.group(2))
    ss = int(m.group(3) or 0)
    frac = m.group(4) or ""
    micros = int((frac + "000000")[:6]) if frac else 0
    tz, zone = _tz_from_suffix(m.group(5) or "")
    if zone is not None and tz is not None:
        # a bare time has no date for DST resolution: pin the named zone's
        # offset at a fixed anchor date so utcoffset()/comparisons work
        # (times are instant-compared on a shared anchor day anyway)
        anchor = _dt.datetime(2000, 1, 1, hh, mm, ss, tzinfo=tz)
        tz = _dt.timezone(anchor.utcoffset() or _dt.timedelta())
    try:
        return FeelTime(_dt.time(hh, mm, ss, micros, tzinfo=tz), zone=zone)
    except ValueError as exc:
        raise TemporalParseError(f"invalid time: {text!r}") from exc


def parse_date_time(text: str) -> FeelDateTime:
    text = text.strip()
    if not _DT_PREFIX_RE.match(text):
        # a bare date is a valid date-and-time at midnight (camunda-feel)
        d = parse_date(text)
        return FeelDateTime(_dt.datetime.combine(d.d, _dt.time(0, 0, 0)))
    date_part, time_part = text.split("T", 1)
    d = parse_date(date_part)
    t = parse_time(time_part)
    tzinfo = t.t.tzinfo
    if t.zone is not None:
        # named zone: resolve DST at the actual date, not parse_time's
        # fixed anchor day
        tz, _ = _tz_from_suffix("@" + t.zone)
        tzinfo = tz
    return FeelDateTime(
        _dt.datetime.combine(d.d, t.t.replace(tzinfo=tzinfo)), zone=t.zone
    )


def parse_duration(text: str) -> Duration | YearMonthDuration:
    text = text.strip()
    ym = _YM_DURATION_RE.match(text)
    if ym and (ym.group("years") or ym.group("months")):
        months = int(ym.group("years") or 0) * 12 + int(ym.group("months") or 0)
        return YearMonthDuration(-months if ym.group("sign") else months)
    m = _DT_DURATION_RE.match(text)
    if m and text not in ("P", "-P", "PT", "-PT"):
        days = float(m.group("days") or 0)
        hours = float(m.group("hours") or 0)
        minutes = float(m.group("minutes") or 0)
        seconds = float(m.group("seconds") or 0)
        if days == hours == minutes == seconds == 0 and "0" not in text:
            raise TemporalParseError(f"empty duration: {text!r}")
        millis = int(((days * 24 + hours) * 60 + minutes) * 60_000 + seconds * 1000)
        return Duration(-millis if m.group("sign") else millis)
    raise TemporalParseError(f"invalid duration: {text!r}")


_DT_PREFIX_RE = re.compile(r"^\d{4}-\d{2}-\d{2}T")


def parse_temporal_literal(text: str) -> Any:
    """Classify an ``@"…"`` literal body by shape (the four FEEL kinds).
    Date-and-time is recognized by its ``YYYY-MM-DDT`` prefix, not by a bare
    'T' search — zone names like Asia/Tokyo contain a T."""
    s = text.strip()
    if s.startswith("P") or s.startswith("-P"):
        return parse_duration(s)
    if _DT_PREFIX_RE.match(s):
        return parse_date_time(s)
    if _DATE_RE.match(s):
        return parse_date(s)
    if _TIME_RE.match(s):
        return parse_time(s)
    raise TemporalParseError(f"unrecognized temporal literal: {text!r}")


# ---------------------------------------------------------------------------
# Calendar arithmetic


def _add_months(d: _dt.date, months: int) -> _dt.date:
    month0 = d.month - 1 + months
    year = d.year + month0 // 12
    month = month0 % 12 + 1
    # clamp to end of month (ISO semantics: Jan 31 + P1M = Feb 28/29)
    day = min(d.day, _days_in_month(year, month))
    return _dt.date(year, month, day)


def _days_in_month(year: int, month: int) -> int:
    if month == 12:
        return 31
    return (_dt.date(year, month + 1, 1) - _dt.timedelta(days=1)).day


def is_temporal(v: Any) -> bool:
    return isinstance(v, (FeelDate, FeelTime, FeelDateTime, Duration, YearMonthDuration))


def temporal_add(left: Any, right: Any) -> Any:
    """FEEL '+' over temporal operands; returns NotImplemented when the pair
    has no defined sum (caller falls through to its numeric path)."""
    # numbers interoperate as milliseconds (FEEL-lite extension)
    if isinstance(left, (int, float)) and not isinstance(left, bool):
        left = Duration(int(left))
    if isinstance(right, (int, float)) and not isinstance(right, bool):
        right = Duration(int(right))
    if isinstance(left, Duration) and isinstance(right, Duration):
        return Duration(left.millis + right.millis)
    if isinstance(left, YearMonthDuration) and isinstance(right, YearMonthDuration):
        return YearMonthDuration(left.months + right.months)
    if isinstance(left, Duration) and isinstance(right, (FeelDateTime, FeelDate, FeelTime)):
        return temporal_add(right, left)
    if isinstance(left, YearMonthDuration) and isinstance(right, (FeelDateTime, FeelDate)):
        return temporal_add(right, left)
    if isinstance(left, FeelDateTime) and isinstance(right, Duration):
        return FeelDateTime(left.dt + _dt.timedelta(milliseconds=right.millis), zone=left.zone)
    if isinstance(left, FeelDateTime) and isinstance(right, YearMonthDuration):
        new_date = _add_months(left.dt.date(), right.months)
        return FeelDateTime(_dt.datetime.combine(new_date, left.dt.timetz()), zone=left.zone)
    if isinstance(left, FeelDate) and isinstance(right, Duration):
        return FeelDate(left.d + _dt.timedelta(milliseconds=right.millis))
    if isinstance(left, FeelDate) and isinstance(right, YearMonthDuration):
        return FeelDate(_add_months(left.d, right.months))
    if isinstance(left, FeelTime) and isinstance(right, Duration):
        anchor = _dt.datetime.combine(_dt.date(2000, 1, 1), left.t)
        moved = anchor + _dt.timedelta(milliseconds=right.millis)
        return FeelTime(moved.timetz(), zone=left.zone)
    return NotImplemented


def temporal_sub(left: Any, right: Any) -> Any:
    """FEEL '-' over temporal operands; NotImplemented when undefined."""
    if isinstance(right, (int, float)) and not isinstance(right, bool):
        right = Duration(int(right))
    if isinstance(left, (int, float)) and not isinstance(left, bool):
        left = Duration(int(left))
    if isinstance(left, FeelDateTime) and isinstance(right, FeelDateTime):
        return Duration(left.epoch_millis - right.epoch_millis)
    if isinstance(left, FeelDate) and isinstance(right, FeelDate):
        return Duration((left.d - right.d).days * 86_400_000)
    if isinstance(left, FeelTime) and isinstance(right, FeelTime):
        anchor = _dt.date(2000, 1, 1)
        a = _dt.datetime.combine(anchor, left.t)
        b = _dt.datetime.combine(anchor, right.t)
        if (a.tzinfo is None) != (b.tzinfo is None):
            return NotImplemented
        return Duration(int((a - b).total_seconds() * 1000))
    if isinstance(left, (FeelDateTime, FeelDate, FeelTime)) and isinstance(
        right, (Duration, YearMonthDuration)
    ):
        return temporal_add(left, -right)
    if isinstance(left, Duration) and isinstance(right, Duration):
        return Duration(left.millis - right.millis)
    if isinstance(left, YearMonthDuration) and isinstance(right, YearMonthDuration):
        return YearMonthDuration(left.months - right.months)
    return NotImplemented


def temporal_mul(left: Any, right: Any) -> Any:
    if isinstance(left, (int, float)) and not isinstance(left, bool):
        left, right = right, left
    if isinstance(right, (int, float)) and not isinstance(right, bool):
        if isinstance(left, Duration):
            return Duration(int(left.millis * right))
        if isinstance(left, YearMonthDuration):
            return YearMonthDuration(int(left.months * right))
    return NotImplemented


def temporal_div(left: Any, right: Any) -> Any:
    if isinstance(left, Duration) and isinstance(right, Duration):
        return None if right.millis == 0 else left.millis / right.millis
    if isinstance(left, YearMonthDuration) and isinstance(right, YearMonthDuration):
        return None if right.months == 0 else left.months / right.months
    if isinstance(right, (int, float)) and not isinstance(right, bool):
        if right == 0:
            return None
        if isinstance(left, Duration):
            return Duration(int(left.millis / right))
        if isinstance(left, YearMonthDuration):
            return YearMonthDuration(int(left.months / right))
    return NotImplemented


# FEEL property names → python attribute (shared by date/time/datetime/durations)
_PROPERTIES = {
    "year": "year",
    "month": "month",
    "day": "day",
    "weekday": "weekday",
    "hour": "hour",
    "minute": "minute",
    "second": "second",
    "time offset": "time_offset",
    "days": "days",
    "hours": "hours",
    "minutes": "minutes",
    "seconds": "seconds",
    "years": "years",
    "months": "months_part",
}


def temporal_property(value: Any, name: str) -> Any:
    attr = _PROPERTIES.get(name)
    if attr is None or not hasattr(type(value), attr):
        return None
    return getattr(value, attr)


def _contains_temporal(v: Any) -> bool:
    if is_temporal(v):
        return True
    if isinstance(v, list):
        return any(_contains_temporal(x) for x in v)
    if isinstance(v, dict):
        return any(_contains_temporal(x) for x in v.values())
    return False


def normalize_value(v: Any) -> Any:
    """Temporal values → ISO strings for the variable store (recursively);
    everything else passes through UNTOUCHED — the common all-plain case must
    not pay a copy on the per-variable hot path. The variable document
    boundary is where rich FEEL values become msgpack-representable
    (reference: feel/src/main/scala/…/MessagePackValueMapper.scala)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if not _contains_temporal(v):
        return v
    if is_temporal(v):
        return str(v)
    if isinstance(v, list):
        return [normalize_value(x) for x in v]
    if isinstance(v, dict):
        return {k: normalize_value(x) for k, x in v.items()}
    return v
